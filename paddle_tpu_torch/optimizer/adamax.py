"""Adamax, the update of ``paddle_tpu/optimizer/adamax.py``:
``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g| + eps)`` and
``w -= lr / (1 - b1^t) * m / u``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adamax"]


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _init_state(self, w):
        return {"moment": torch.zeros_like(w),
                "inf_norm": torch.zeros_like(w)}

    def _update(self, weights, grads, states, lrs, t):
        b1, b2 = self._beta1, self._beta2
        m = [s["moment"] for s in states]
        u = [s["inf_norm"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(u, b2)
        g_abs = torch._foreach_abs(grads)
        torch._foreach_add_(g_abs, self._epsilon)
        torch._foreach_maximum_(u, g_abs)
        corr = 1 - b1 ** t
        step = torch._foreach_mul(m, [lr / corr for lr in lrs])
        torch._foreach_div_(step, u)
        torch._foreach_sub_(weights, step)
