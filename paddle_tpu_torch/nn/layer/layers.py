"""``Layer``, the base of the port's layer set (counterpart of
``paddle_tpu/nn/layer/layers.py``).

A ``Layer`` is a ``torch.nn.Module``: parameters, buffers and sublayers
register through torch's ``__setattr__``; ``train()``, ``eval()``,
``parameters()``, ``named_parameters()``, ``state_dict()`` and the
forward hooks are torch's. It adds the JAX ``Layer``'s own methods:
``create_parameter`` (ParamAttr, the layer's default initializer, the
global one and ``param_init_override``, in the JAX precedence),
``add_parameter``, ``add_sublayer``, ``register_buffer(persistable=)``,
``set_state_dict`` (numpy arrays or tensors, shapes checked, returns the
missing and unexpected names), ``sublayers``/``named_sublayers``,
``register_forward_post_hook``, and ``to``/``astype`` with the JAX
dtype names.

Layers are built on the CPU, like torch modules; a model's entry point
(``vision.models.resnet50(device=)``) moves it to the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import initializer as I
from ..parameter import Parameter, ParamAttr

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # -- construction ------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new ``Parameter`` of ``shape``, drawn from the generator of
        the innermost ``initializer.init_generator`` block."""
        attr = ParamAttr._to_attr(attr)
        dtype = I._init_override["dtype"] or dtype or self._dtype
        init = (I._init_override["initializer"] or attr.initializer
                or default_initializer
                or (I.Constant(0.0) if is_bias
                    else I._global_initializer["weight"]))
        data = init(list(shape), dtype=dtype,
                    generator=I.current_generator())
        p = Parameter(data, trainable=attr.trainable, name=attr.name)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        """Register ``parameter`` (or None) as ``name``, replacing a plain
        attribute of that name."""
        if parameter is not None and not isinstance(parameter,
                                                    torch.nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        if name in self.__dict__ and name not in self._parameters:
            del self.__dict__[name]
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """torch's ``register_buffer``; ``persistable=False`` (the JAX
        name) keeps it out of the state dict."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=keep)
        return tensor

    # -- traversal ---------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``, torch's forward hook."""
        return self.register_forward_hook(hook)

    def full_name(self):
        return self._name_scope

    # -- state dict --------------------------------------------------------
    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` (names -> tensors or numpy arrays) into the
        layer's parameters and persistable buffers, cast to each one's
        dtype and device. Raises ``ValueError`` on a shape mismatch;
        returns (missing, unexpected) names."""
        own = self.state_dict(keep_vars=True)
        missing = []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            src = (src.detach() if isinstance(src, torch.Tensor)
                   else torch.as_tensor(np.array(src)))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: ckpt {tuple(src.shape)} vs "
                    f"model {tuple(target.shape)}")
            target.copy_(src)
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype / device ----------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to``, also taking the JAX form ``to(device=None,
        dtype=None, blocking=None)`` with dtype names ("float32",
        "bfloat16", ...); a dtype casts the floating parameters and
        buffers."""
        kwargs.pop("blocking", None)
        args = tuple(I._dtype(a) if isinstance(a, str) and a in I._DTYPES
                     else a for a in args)
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = I._dtype(kwargs["dtype"])
        if kwargs.get("device", 0) is None:
            kwargs.pop("device")
        if kwargs.get("dtype", 0) is None:
            kwargs.pop("dtype")
        out = super().to(*args, **kwargs)
        dtype = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if dtype is not None:
            self._dtype = str(dtype).removeprefix("torch.")
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)
