"""Adagrad, the update of ``paddle_tpu/optimizer/adagrad.py``:
``G += g^2``, ``w -= lr * g / (sqrt(G) + eps)``; ``G`` starts at
``initial_accumulator_value``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adagrad"]


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._epsilon = float(epsilon)
        self._initial = float(initial_accumulator_value)

    def _init_state(self, w):
        return {"moment": torch.full_like(w, self._initial)}

    def _update(self, weights, grads, states, lrs, t):
        moment = [s["moment"] for s in states]
        torch._foreach_add_(moment, torch._foreach_mul(grads, grads))
        denom = torch._foreach_sqrt(moment)
        torch._foreach_add_(denom, self._epsilon)
        step = torch._foreach_mul(grads, lrs)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(weights, step)
