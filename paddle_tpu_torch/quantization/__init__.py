"""Weight-only int8 quantization of MoE experts.

Counterpart of the MoE part of ``paddle_tpu/quantization``:
``weight_quantize_grouped`` (per-expert, per-output-channel absmax int8)
and ``quantize_moe_experts`` (the in-place deployment conversion of every
``incubate.SwiGLUExperts``). QAT, PTQ and the dense ``quantize_weights``
are not ported.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["weight_quantize_grouped", "quantize_moe_experts"]


def weight_quantize_grouped(w):
    """Stacked expert weights ``[e, k, f]`` -> (int8 ``[e, k, f]``, scales
    ``[e, f]``): one scale per (expert, output channel), the absmax over
    the contraction axis, with ``w ~ q * scales[:, None, :]``. The
    arithmetic stays in ``w``'s dtype and keeps the JAX expression order,
    ``round(w / absmax * 127)``, so the int8 values are bit-identical to
    the JAX package's default ``bits=8``, the only width the port's
    kernel takes."""
    if w.dim() != 3:
        raise ValueError(
            f"weight_quantize_grouped expects stacked [e, k, f] expert "
            f"weights, got shape {tuple(w.shape)}"
        )
    w = w.detach()
    qmax = 127.0
    scale = torch.clamp_min(w.abs().amax(dim=1, keepdim=True), 1e-8)
    q = torch.clamp(torch.round(w / scale * qmax), -qmax, qmax)
    return q.to(torch.int8), scale[:, 0, :] / qmax


@torch.no_grad()
def quantize_moe_experts(model):
    """Replace, IN PLACE, the three stacked projections of every
    ``SwiGLUExperts`` under ``model`` by int8 weights (parameters that
    need no gradient) and register their f32 per-channel scales as the
    ``*_scale`` buffers, so ``state_dict()`` carries them. The quantized
    experts run only through ``MoELayer(impl="ragged")``, where
    ``grouped_matmul`` dequantizes in the kernel; inference only.
    Returns {sublayer name ("root" for ``model`` itself): bytes saved}."""
    from ..incubate.moe import SwiGLUExperts

    out = {}
    for name, sub in model.named_modules():
        if not isinstance(sub, SwiGLUExperts) or sub.quantized:
            continue
        saved = 0
        for wn in ("w_gate", "w_up", "w_down"):
            w = getattr(sub, wn)
            q, s = weight_quantize_grouped(w)
            s = s.float()
            before = w.numel() * w.element_size()
            setattr(sub, wn, nn.Parameter(q, requires_grad=False))
            sub.register_buffer(wn + "_scale", s)
            saved += before - (q.numel() * q.element_size()
                               + s.numel() * s.element_size())
        out[name or "root"] = saved
    return out
