"""LAMB, the update of ``paddle_tpu/optimizer/lamb.py``: the Adam
direction with bias correction plus the decoupled decay,
``u = m_hat / (sqrt(v_hat) + eps) + wd * w``, scaled per tensor by the
trust ratio ``||w|| / ||u||`` (1 where either norm is 0):
``w -= lr * trust * u``. ``exclude_from_weight_decay_fn(param)`` True
drops ``wd`` for that parameter. The norms come from
``torch._foreach_norm`` (one per tensor, on the device); the ratio stays
on the device."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Lamb"]


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=None, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._lamb_weight_decay = float(lamb_weight_decay)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._exclude_fn = exclude_from_weight_decay_fn
        self._decays = []

    def _init_state(self, w):
        return {"moment1": torch.zeros_like(w),
                "moment2": torch.zeros_like(w)}

    def _collect(self):
        triples = super()._collect()
        self._decays = [
            0.0 if self._exclude_fn is not None and self._exclude_fn(p)
            else self._lamb_weight_decay
            for p, _, _ in triples
        ]
        return triples

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
        denom = torch._foreach_div(v, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_div_(m_hat, denom)
        update = m_hat
        torch._foreach_add_(update, torch._foreach_mul(weights, self._decays))
        w_norm = torch.stack(torch._foreach_norm(weights))
        u_norm = torch.stack(torch._foreach_norm(update))
        trust = torch.where((w_norm > 0) & (u_norm > 0),
                            w_norm / u_norm, torch.ones_like(w_norm))
        scale = trust * torch.tensor(lrs, dtype=trust.dtype,
                                     device=trust.device)
        torch._foreach_mul_(update, list(scale.unbind()))
        torch._foreach_sub_(weights, update)
