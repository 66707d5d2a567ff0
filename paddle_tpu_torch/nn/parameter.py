"""``Parameter`` and ``ParamAttr`` (counterpart of
``paddle_tpu/nn/parameter.py``).

``Parameter`` is a ``torch.nn.Parameter`` that carries the JAX
parameter's attributes: ``trainable`` (``requires_grad``; its inverse
``stop_gradient``), ``optimize_attr`` (the learning-rate scale),
``regularizer`` and ``need_clip``, which the optimizer and the gradient
clips read, and ``persistable``. The JAX ``name`` is kept as
``param_name`` (a torch tensor's ``name`` cannot be set)."""
from __future__ import annotations

import torch

__all__ = ["Parameter", "ParamAttr"]


class Parameter(torch.nn.Parameter):
    def __new__(cls, data, trainable=True, name=None):
        p = super().__new__(cls, data, requires_grad=bool(trainable))
        p.param_name = name
        p.persistable = True
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        return p

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __repr__(self):
        return "Parameter containing:\n" + torch.Tensor.__repr__(self)


class ParamAttr:
    """A parameter's name, initializer, learning-rate scale, regularizer,
    trainability and clipping, as the JAX ``ParamAttr``."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None, a ParamAttr, a name or an initializer -> a ParamAttr."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)
