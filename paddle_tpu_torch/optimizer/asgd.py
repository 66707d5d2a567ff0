"""ASGD, averaged SGD, the update of ``paddle_tpu/optimizer/asgd.py``:
``w -= lr * g``, and the running average of the iterates over a window
of ``batch_num`` steps, ``a += (w - a) / min(t, batch_num)``, in
``avg_param``; ``finalize()`` copies the averages into the
parameters."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["ASGD"]


class ASGD(Optimizer):
    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(
            learning_rate=learning_rate, parameters=parameters,
            weight_decay=weight_decay, grad_clip=grad_clip, name=name,
            multi_precision=multi_precision,
        )
        self._batch_num = int(batch_num)

    def _init_state(self, w):
        return {"avg_param": w.clone()}

    def _update(self, weights, grads, states, lrs, t):
        torch._foreach_sub_(weights, torch._foreach_mul(grads, lrs))
        avg = [s["avg_param"] for s in states]
        diff = torch._foreach_sub(weights, avg)
        torch._foreach_div_(diff, float(min(t, max(self._batch_num, 1))))
        torch._foreach_add_(avg, diff)

    @torch.no_grad()
    def finalize(self):
        """Copy the averaged parameters into the model."""
        for p in self._parameter_list:
            st = self._accumulators.get(id(p))
            if st and "avg_param" in st:
                p.copy_(st["avg_param"])
