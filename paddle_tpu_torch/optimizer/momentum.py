"""Momentum SGD, the update of ``paddle_tpu/optimizer/momentum.py``:
``v = mu * v + g``, then ``w -= lr * v``, or with Nesterov
``w -= lr * (g + mu * v)``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Momentum"]


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _init_state(self, w):
        return {"velocity": torch.zeros_like(w)}

    def _update(self, weights, grads, states, lrs, t):
        v = [s["velocity"] for s in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        if self._use_nesterov:
            step = torch._foreach_mul(v, self._momentum)
            torch._foreach_add_(step, grads)
            torch._foreach_mul_(step, lrs)
        else:
            step = torch._foreach_mul(v, lrs)
        torch._foreach_sub_(weights, step)
