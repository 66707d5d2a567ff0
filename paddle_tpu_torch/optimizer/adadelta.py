"""Adadelta, the update of ``paddle_tpu/optimizer/adadelta.py``:
``E[g^2] = rho E[g^2] + (1 - rho) g^2``,
``d = sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) * g``,
``E[dx^2] = rho E[dx^2] + (1 - rho) d^2`` and ``w -= lr * d``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adadelta"]


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._epsilon = float(epsilon)
        self._rho = float(rho)

    def _init_state(self, w):
        return {"avg_squared_grad": torch.zeros_like(w),
                "avg_squared_update": torch.zeros_like(w)}

    def _update(self, weights, grads, states, lrs, t):
        rho, eps = self._rho, self._epsilon
        avg_g = [s["avg_squared_grad"] for s in states]
        avg_u = [s["avg_squared_update"] for s in states]
        torch._foreach_mul_(avg_g, rho)
        torch._foreach_add_(avg_g, torch._foreach_mul(grads, grads),
                            alpha=1 - rho)
        delta = torch._foreach_add(avg_u, eps)
        torch._foreach_sqrt_(delta)
        denom = torch._foreach_add(avg_g, eps)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(delta, denom)
        torch._foreach_mul_(delta, grads)
        torch._foreach_mul_(avg_u, rho)
        torch._foreach_add_(avg_u, torch._foreach_mul(delta, delta),
                            alpha=1 - rho)
        torch._foreach_mul_(delta, lrs)
        torch._foreach_sub_(weights, delta)
