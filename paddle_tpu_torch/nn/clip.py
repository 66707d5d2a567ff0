"""Gradient clipping.

Counterpart of ``ClipGradByGlobalNorm`` in ``paddle_tpu/nn/clip.py``: one
norm over every gradient that needs a clip, accumulated in f32 whatever
the gradients' dtype, and every such gradient scaled by
``clip_norm / max(global_norm, clip_norm)``. ``ClipGradByValue`` and
``ClipGradByNorm`` are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def clip_(self, grads, need_clip):
        """Clip ``grads`` (tensors, or None for a parameter without one)
        in place where ``need_clip`` is true; the norm stays on the
        device (no host sync)."""
        todo = [g for g, n in zip(grads, need_clip) if g is not None and n]
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
