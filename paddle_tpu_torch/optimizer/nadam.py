"""NAdam, the update of ``paddle_tpu/optimizer/nadam.py``: Adam with
Nesterov momentum under the mu-product schedule
``mu_t = b1 (1 - 0.5 * 0.96^(t psi))``; each parameter carries the
running product of the ``mu_t`` (``mu_product``, a scalar on its
device), and
``w -= lr * (mu_{t+1} m / (1 - prod mu_{..t+1}) + (1 - mu_t) g /
(1 - prod mu_{..t})) / (sqrt(v / (1 - b2^t)) + eps)``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["NAdam"]


class NAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._momentum_decay = float(momentum_decay)

    def _init_state(self, w):
        return {"moment1": torch.zeros_like(w),
                "moment2": torch.zeros_like(w),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=w.device)}

    def _update(self, weights, grads, states, lrs, t):
        b1, b2, psi = self._beta1, self._beta2, self._momentum_decay
        mu_t = b1 * (1 - 0.5 * 0.96 ** (t * psi))
        mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * psi))
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        mu_prod = [s["mu_product"] for s in states]
        torch._foreach_mul_(mu_prod, mu_t)
        # per parameter: mu_{t+1} / (1 - prod * mu_{t+1}) and
        # (1 - mu_t) / (1 - prod), scalars on the device
        prod = torch.stack(mu_prod)
        c_m = mu_t1 / (1 - prod * mu_t1)
        c_g = (1 - mu_t) / (1 - prod)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(grads, grads),
                            alpha=1 - b2)
        m_hat = torch._foreach_mul(m, list(c_m.unbind()))
        torch._foreach_add_(m_hat, torch._foreach_mul(grads,
                                                      list(c_g.unbind())))
        denom = torch._foreach_div(v, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_mul_(m_hat, lrs)
        torch._foreach_div_(m_hat, denom)
        torch._foreach_sub_(weights, m_hat)
