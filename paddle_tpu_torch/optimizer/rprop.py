"""Rprop, resilient backpropagation, the update of
``paddle_tpu/optimizer/rprop.py``. Each element keeps its own step size
(``learning_rate_elem``, starting at ``learning_rate``): times
``etas[1]`` where the gradient kept its sign since the last step, times
``etas[0]`` where it flipped, clipped to ``learning_rate_range``; then
``w -= step * sign(g)``, except where the sign flipped, which takes no
step and forgets its gradient (``prev_grad`` 0 there). Full-batch
only, as in the JAX package."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Rprop"]


class Rprop(Optimizer):
    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=None, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._lr_min = float(learning_rate_range[0])
        self._lr_max = float(learning_rate_range[1])
        self._eta_minus = float(etas[0])
        self._eta_plus = float(etas[1])
        self._initial_lr = float(
            learning_rate if isinstance(learning_rate, (int, float))
            else 0.001)

    def _init_state(self, w):
        return {"prev_grad": torch.zeros_like(w),
                "learning_rate_elem": torch.full_like(w, self._initial_lr)}

    def _update(self, weights, grads, states, lrs, t):
        prev = [s["prev_grad"] for s in states]
        lre = [s["learning_rate_elem"] for s in states]
        sign = torch._foreach_sign(torch._foreach_mul(grads, prev))
        # the selections by sign, one where per tensor (no foreach form)
        factor = [torch.where(s > 0, self._eta_plus,
                              torch.where(s < 0, self._eta_minus, 1.0))
                  .to(s.dtype) for s in sign]
        torch._foreach_mul_(lre, factor)
        torch._foreach_clamp_min_(lre, self._lr_min)
        torch._foreach_clamp_max_(lre, self._lr_max)
        g_eff = [torch.where(s < 0, 0.0, g).to(g.dtype)
                 for s, g in zip(sign, grads)]
        torch._foreach_sub_(weights, torch._foreach_mul(
            lre, torch._foreach_sign(g_eff)))
        torch._foreach_copy_(prev, g_eff)
