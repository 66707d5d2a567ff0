"""Flash attention forward.

Counterpart of the forward half of
``paddle_tpu/kernels/pallas/flash_attention.py`` (``_flash_fwd``): an
online-softmax attention that returns the output and the per-row
logsumexp, which a backward kernel reads (the backward is not ported
yet).

Layout as in the JAX public op: q [batch, sq, heads, d], k/v
[batch, sk, kv_heads, d] with ``heads % kv_heads == 0`` (GQA is read in
place); out [batch, sq, heads, d]; lse [batch, heads, sq] float32. The
causal mask is top-left aligned (query i sees keys j <= i), as in the
TPU kernel; ``ops.nn_ops.scaled_dot_product_attention`` sends causal
calls here only when sq == sk. Unlike the TPU kernel, sequence lengths
need not be multiples of the tile.

``flash_attention_fwd`` launches the CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and takes the plain PyTorch
version ``flash_attention_ref`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_ref",
           "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd_launch.argtypes = [
            vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci,
            ci, vp,
        ]
        lib.flash_attention_fwd_launch.restype = ci
        _lib = lib
    return _lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: want q [b, sq, h, d], k/v [b, sk, hkv, d], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)}"
        )


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary (the bf16
    kernel stages rows with 16-byte loads): a copy if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_fwd(q, k, v, *, causal=True, scale=None):
    """-> (out [b, sq, h, d] in q's dtype, lse [b, h, sq] float32)."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel: head_dim {d} not in "
            f"{SUPPORTED_HEAD_DIMS}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, sq, sk, d, float(scale),
            int(bool(causal)), dtype, stream,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch("flash_attention")
    return out, lse


def flash_attention_ref(q, k, v, *, causal=True, scale=None):
    """Plain PyTorch version: f32 scores, top-left causal mask, softmax.
    Returns (out in q's dtype, lse [b, h, sq] float32)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    qf = q.transpose(1, 2).float()            # [b, h, sq, d]
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype), lse
