"""SGD, the update of ``paddle_tpu/optimizer/sgd.py``: ``w -= lr * g``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )

    def _update(self, weights, grads, states, lrs, t):
        torch._foreach_sub_(weights, torch._foreach_mul(grads, lrs))
