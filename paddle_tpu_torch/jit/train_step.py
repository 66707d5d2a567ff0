"""One training step: forward, backward, clip and update.

Counterpart of ``TrainStep`` in ``paddle_tpu/jit/api.py``. The JAX
package stages the whole step into one XLA program; PyTorch runs it
eagerly, so here it is the same sequence of calls made in order. What
``jit.TrainStep`` does beyond that is not ported: the compiled single
program and its donated buffers, ZeRO gradient shardings, the NaN/Inf
nets and the random-key lifting.
"""
from __future__ import annotations

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer, accum_steps=None)``;
    ``step(*args, **kwargs)`` runs ``loss_fn(model, *args, **kwargs)``,
    its backward, the optimizer's clip and update, clears the gradients
    and returns the loss, detached.

    ``accum_steps=k`` splits the leading batch axis of every tensor
    argument into k micro-batches, runs forward and backward on each
    (one micro-batch's activations alive at a time), sums the gradients
    in f32, and applies one update with their mean cast to each
    parameter's dtype: within f32 rounding the step that one k-times
    larger batch takes. The returned loss is the mean of the micro-batch
    losses. The optimizer's LR scheduler is stepped by the caller, as in
    the JAX package."""

    def __init__(self, model, loss_fn, optimizer, accum_steps=None):
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._accum = 1 if accum_steps is None else int(accum_steps)
        if self._accum < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self._params = [p for p in optimizer._parameter_list
                        if p.requires_grad]

    def __call__(self, *args, **kwargs):
        for p in self._params:
            p.grad = None
        if self._accum == 1:
            loss = self._loss_fn(self._model, *args, **kwargs)
            loss.backward()
            loss = loss.detach()
        else:
            loss = self._accumulate(args, kwargs)
        self._opt.step()
        for p in self._params:
            p.grad = None
        return loss

    def _accumulate(self, args, kwargs):
        k = self._accum

        def split(a):
            if not isinstance(a, torch.Tensor) or a.dim() == 0:
                raise ValueError(
                    "accum_steps requires every data input to have a "
                    f"leading batch axis to micro-split; got {a!r}"
                )
            if a.shape[0] % k:
                raise ValueError(
                    f"batch axis {a.shape[0]} not divisible by "
                    f"accum_steps={k}"
                )
            return a.chunk(k, dim=0)

        parts = [split(a) for a in args]
        kw_parts = {n: split(a) for n, a in kwargs.items()}
        sums = {}
        losses = []
        for i in range(k):
            loss = self._loss_fn(
                self._model, *(p[i] for p in parts),
                **{n: p[i] for n, p in kw_parts.items()},
            )
            loss.backward()
            losses.append(loss.detach())
            with torch.no_grad():
                for p in self._params:
                    if p.grad is None:
                        continue
                    if id(p) in sums:
                        sums[id(p)].add_(p.grad.float())
                    else:
                        sums[id(p)] = p.grad.float()
                    p.grad = None
        with torch.no_grad():
            for p in self._params:
                if id(p) in sums:
                    p.grad = (sums[id(p)] * (1.0 / k)).to(p.dtype)
        return torch.stack(losses).mean()
