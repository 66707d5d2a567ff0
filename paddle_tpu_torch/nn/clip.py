"""Gradient clipping.

Counterpart of ``paddle_tpu/nn/clip.py``: ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` on a ``ClipGradBase``.
Each clips only the gradients whose parameter needs it (a parameter's
``need_clip`` attribute, True by default). Norms are accumulated in f32
whatever the gradients' dtype, and a scaled gradient is one f32 product
rounded once to its dtype, as in the JAX package's ``_clip_arrays``.

The optimizer clips in place through ``clip_(grads, need_clip)`` (the
norms stay on the device: no host sync); ``clip(params_grads)`` is the
eager ``(param, grad)`` list form, which returns new gradients.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        """A list of (param, grad) -> the same with clipped gradients
        (new tensors; the parameters' ``.grad`` are left alone)."""
        grads = [None if g is None else g.detach().clone()
                 for _, g in params_grads]
        self.clip_(grads, [self.need_clip(p) for p, _ in params_grads])
        return [(p, g) for (p, _), g in zip(params_grads, grads)]

    @staticmethod
    def need_clip(param):
        """Whether ``param``'s gradient is clipped: its ``need_clip``
        attribute, True when it has none."""
        return getattr(param, "need_clip", True)

    def clip_(self, grads, need_clip):
        """Clip ``grads`` (tensors, or None for a parameter without one)
        in place where ``need_clip`` is true; returns ``grads``."""
        raise NotImplementedError


def _todo(grads, need_clip):
    return [g for g, n in zip(grads, need_clip) if g is not None and n]


class ClipGradByValue(ClipGradBase):
    """Every element clipped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __str__(self):
        return f"Clip Gradient By Value, min = {self.min}, max={self.max}"

    @torch.no_grad()
    def clip_(self, grads, need_clip):
        for g in _todo(grads, need_clip):
            g.clamp_(self.min, self.max)
        return grads


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(clip_norm / max(||g||, 1e-12), 1), its
    own L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __str__(self):
        return f"Gradient Clip By Norm, clip_norm={self.clip_norm}"

    @torch.no_grad()
    def clip_(self, grads, need_clip):
        for g in _todo(grads, need_clip):
            norm = torch.linalg.vector_norm(g, dtype=torch.float32)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            g.copy_(g.float() * scale)
        return grads


class ClipGradByGlobalNorm(ClipGradBase):
    """One norm over every gradient that needs a clip, and every such
    gradient scaled by ``clip_norm / max(global_norm, clip_norm)``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def __str__(self):
        return f"Gradient Clip By GlobalNorm, global_norm={self.clip_norm}"

    @torch.no_grad()
    def clip_(self, grads, need_clip):
        todo = _todo(grads, need_clip)
        if not todo:
            return grads
        norm = torch.stack([
            torch.linalg.vector_norm(g, dtype=torch.float32) for g in todo
        ]).square().sum().sqrt()
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        for g in todo:
            # f32 product, one rounding to the gradient's dtype
            g.copy_(g.float() * scale)
        return grads
