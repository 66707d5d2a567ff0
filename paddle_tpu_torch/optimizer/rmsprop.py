"""RMSProp, the update of ``paddle_tpu/optimizer/rmsprop.py``:
``E[g^2] = rho E[g^2] + (1 - rho) g^2``; centered, also
``E[g] = rho E[g] + (1 - rho) g`` and the denominator
``sqrt(E[g^2] - E[g]^2 + eps)``, else ``sqrt(E[g^2] + eps)``; then the
momentum ``v = mu v + lr g / denom`` and ``w -= v``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["RMSProp"]


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        if learning_rate is None:
            raise ValueError("learning_rate is not set")
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)

    def _init_state(self, w):
        st = {"momentum": torch.zeros_like(w),
              "mean_square": torch.zeros_like(w)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(w)
        return st

    def _update(self, weights, grads, states, lrs, t):
        rho = self._rho
        ms = [s["mean_square"] for s in states]
        torch._foreach_mul_(ms, rho)
        torch._foreach_add_(ms, torch._foreach_mul(grads, grads),
                            alpha=1 - rho)
        if self._centered:
            mg = [s["mean_grad"] for s in states]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        mom = [s["momentum"] for s in states]
        step = torch._foreach_mul(grads, lrs)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, step)
        torch._foreach_sub_(weights, mom)
