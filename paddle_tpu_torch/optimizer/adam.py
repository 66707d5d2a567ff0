"""Adam, the update of ``paddle_tpu/optimizer/adam.py``.

Bias correction comes from the global step (no per-parameter beta-power
accumulators), in the rescaled form of the JAX package:
``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` with
``eps_t = eps * sqrt(1 - beta2^t)``, and
``w -= lr_t * m / (sqrt(v) + eps_t)`` (``sqrt(max v)`` with amsgrad).
"""
from __future__ import annotations

import math

import torch

from .optimizer import Optimizer

__all__ = ["Adam"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, amsgrad=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip,
            multi_precision=multi_precision,
        )
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = bool(amsgrad)

    def _init_state(self, w):
        st = {"moment1": torch.zeros_like(w), "moment2": torch.zeros_like(w)}
        if self._amsgrad:
            st["moment2_max"] = torch.zeros_like(w)
        return st

    def _update(self, weights, grads, states, lrs, t):
        b1, b2 = self._beta1, self._beta2
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        if self._amsgrad:
            v_max = [s["moment2_max"] for s in states]
            torch._foreach_maximum_(v_max, v)
            v = v_max
        corr2 = math.sqrt(1.0 - b2 ** t)
        corr1 = 1.0 - b1 ** t
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self._epsilon * corr2)
        torch._foreach_addcdiv_(weights, m, denom,
                                [-lr * corr2 / corr1 for lr in lrs])
