"""Rotary position embedding for the Llama path.

Counterpart of ``rope_qk`` and the parts of
``fused_rotary_position_embedding`` it uses in
``paddle_tpu/ops/impl/fused_ops.py``: rotation angles built from the
base, per-row ``position_ids``, neox (rotate-halves) style, f32 math cast
back to the input dtype. q/k are [batch, seq, heads, head_dim]. The
GPT-J (interleaved) style is not ported: Llama does not use it.
"""
from __future__ import annotations

import torch

__all__ = ["rope_qk"]


def _rope_cache(seq_len, head_dim, base, device, position_ids=None):
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=device) / head_dim)
    )
    if position_ids is None:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)[None]
    else:
        t = position_ids.to(device=device, dtype=torch.float32)
    freqs = t[..., None] * inv_freq                 # [b, s, d/2]
    return torch.cos(freqs), torch.sin(freqs)


def _apply_rope(x, cos, sin):
    xf = x.float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def rope_qk(q, k, position_ids=None, *, base=10000.0):
    """Rotate q and k. ``position_ids`` ([b, s] or [s]) gives each token's
    absolute position (decode rotates the new token at its cache
    position); None means positions 0..s-1."""
    if position_ids is not None and position_ids.dim() == 1:
        position_ids = position_ids[None, :]
    cos, sin = _rope_cache(
        q.shape[1], q.shape[-1], base, q.device, position_ids
    )
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
