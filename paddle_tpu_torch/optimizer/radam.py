"""RAdam, rectified Adam, the update of ``paddle_tpu/optimizer/radam.py``.
The rectification is a function of the step alone: with
``rho_inf = 2 / (1 - b2) - 1`` and
``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)``, a step with ``rho_t > 5``
is ``w -= lr * r_t * m_hat / (sqrt(v / (1 - b2^t)) + eps)``, any other
``w -= lr * m_hat``, with ``m_hat = m / (1 - b1^t)``."""
from __future__ import annotations

import math

import torch

from .optimizer import Optimizer

__all__ = ["RAdam"]


class RAdam(Optimizer):
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
        return {"moment1": torch.zeros_like(w),
                "moment2": torch.zeros_like(w)}

    def _update(self, weights, grads, states, lrs, t):
        b1, b2 = self._beta1, self._beta2
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(grads, grads),
                            alpha=1 - b2)
        m_hat = torch._foreach_div(m, 1 - b1 ** t)
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** t
        rho_t = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
        if rho_t > 5.0:
            r_t = math.sqrt(max(
                (rho_t - 4.0) * (rho_t - 2.0) * rho_inf
                / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho_t), 0.0))
            denom = torch._foreach_div(v, 1.0 - b2t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self._epsilon)
            torch._foreach_mul_(m_hat, [lr * r_t for lr in lrs])
            torch._foreach_div_(m_hat, denom)
        else:
            torch._foreach_mul_(m_hat, lrs)
        torch._foreach_sub_(weights, m_hat)
