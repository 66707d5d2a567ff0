"""Continuation (paged-context) prefill attention.

A prefill chunk whose first ``cache_len`` tokens already sit in the
sequence's KV pages (an earlier chunk, or a prefix forked from the prefix
cache) attends over those pages and its own, read through the block
table:

  q            [S, num_q_heads, head_dim]  chunk token t at global
               position ``cache_len + t``
  k_pages      [num_kv_heads, num_pages, page_size, head_dim] (one
  v_pages      layer), float of q's dtype, or an int8 ``(pages, scales
               f32 [num_kv_heads, num_pages, page_size])`` pair
  block_table  [pages_per_seq] int32 (logical page i -> physical page)
  cache_len    int32 scalar tensor on q's device
  length       int32 scalar tensor on q's device: valid chunk tokens

Query t < ``length`` attends to the keys at global positions
``c <= cache_len + t`` (JAX's ``keep`` mask, ``paddle_tpu/serving/
adapter.py:411-417``). Rows t >= ``length`` are finite and never read.
GQA: query heads are grouped per kv head. The chunk's own K/V must be
written into the pages first (``kernels.kv_write``).

In the JAX package this is XLA, not a TPU kernel: ``_gather_context``
(:246) then the masked ``_sdpa`` (:428-432). ``paged_prefill`` launches
the hand-written kernel ``csrc/paged_prefill.cu`` on CUDA tensors
(counted ``paged_prefill``, variant ``float`` or ``int8``): its grid is
fixed by S and the heads, and it reads ``cache_len`` and ``length`` from
device memory, so one CUDA graph replays any chunk at any offset. CPU
tensors take the plain version ``paged_prefill_ref`` (a gather of the
context, then the masked product; fixed-shape and free of host syncs,
like the kernel), which the serving adapter also runs by name when its
``decode_kernel`` is ``"xla"``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import split_pages

__all__ = ["paged_prefill", "paged_prefill_ref", "HEAD_DIMS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)
# the 16-bit kernels keep the block table in shared memory beside their
# tiles: 8192 entries fit at every head dim
MAX_PAGES_PER_SEQ = 8192
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_prefill")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_prefill_launch.argtypes = (
            [vp] * 9 + [ci] * 7 + [ctypes.c_float, ci, ci, vp])
        lib.paged_prefill_launch.restype = ci
        _lib = lib
    return _lib


def _check(q, kq, ks, vq, vs, block_table):
    if (ks is None) != (vs is None):
        raise ValueError(
            "paged_prefill: k and v pages must both be int8 (pages, scales) "
            "pairs or both float tensors")
    if q.dim() != 3 or kq.dim() != 4 or vq.shape != kq.shape:
        raise ValueError(
            f"paged_prefill: want q [S, hq, d] and k/v pages [hkv, pages, "
            f"page_size, d], got {tuple(q.shape)}, {tuple(kq.shape)}, "
            f"{tuple(vq.shape)}")
    hq, d = q.shape[1], q.shape[2]
    if hq % kq.shape[0] or kq.shape[3] != d:
        raise ValueError(
            f"paged_prefill: q heads {hq} / head_dim {d} do not fit pages "
            f"{tuple(kq.shape)}")
    if block_table.dim() != 1:
        raise ValueError("paged_prefill: block_table must be [P]")
    if ks is not None:
        if kq.dtype != torch.int8 or vq.dtype != torch.int8:
            raise TypeError("paged_prefill: quantized pages must be int8")
        if ks.shape != kq.shape[:3] or vs.shape != kq.shape[:3]:
            raise ValueError(
                "paged_prefill: scales must be [hkv, pages, page_size]")


def paged_prefill(q, k_pages, v_pages, block_table, cache_len, length, *,
                  scale=None):
    """Continuation attention -> [S, num_q_heads, head_dim] in q's dtype
    (see the module). CUDA tensors launch ``csrc/paged_prefill.cu``
    (float32, bfloat16 or float16 q; pages of q's dtype or int8 pairs;
    head_dim 16, 32, 64, 128 or 256); CPU tensors run
    ``paged_prefill_ref``."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    _check(q, kq, ks, vq, vs, block_table)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    cache_len, length = cache_len.reshape(()), length.reshape(())
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_pages, v_pages, block_table,
                                 cache_len, length, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill: unsupported device {q.device}")
    quant = ks is not None
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_prefill kernel takes float32, bfloat16 or "
                        f"float16 q, got {q.dtype}")
    page_dtype = torch.int8 if quant else q.dtype
    if kq.dtype != page_dtype or vq.dtype != page_dtype:
        raise TypeError(
            f"paged_prefill kernel takes pages of q's dtype or int8 pairs, "
            f"got q {q.dtype}, pages {kq.dtype}/{vq.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_prefill kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if block_table.shape[0] > MAX_PAGES_PER_SEQ:
        raise ValueError(
            f"paged_prefill kernel: a block table of {block_table.shape[0]} "
            f"pages does not fit its shared memory (at most "
            f"{MAX_PAGES_PER_SEQ})")
    named = [("k_pages", kq), ("v_pages", vq), ("block_table", block_table),
             ("cache_len", cache_len), ("length", length)]
    if quant:
        named += [("k_scales", ks), ("v_scales", vs)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(
                f"paged_prefill: {name} is on {t.device}, q on {q.device}")
    for name, t in named[:2] + named[5:]:
        if not t.is_contiguous():
            raise ValueError(f"paged_prefill kernel: {name} must be "
                             f"contiguous")
    if quant and (ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise TypeError("paged_prefill kernel: scales must be float32")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    return _launch(q, kq, vq, ks, vs, block_table.to(torch.int32).contiguous(),
                   cache_len.to(torch.int32).contiguous(),
                   length.to(torch.int32).contiguous(), float(scale))


def _launch(q, kq, vq, ks, vs, table, cache_len, length, scale):
    """The kernel on checked inputs (contiguous, q 16-byte aligned, int32
    table and scalars) -> out in q's dtype, counted. ``chip_smoke.py``
    times this alone, without the wrapper's checks."""
    quant = ks is not None
    out = torch.empty_like(q)
    s, hq, d = q.shape
    hkv, n_pages, page_size, _ = kq.shape
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.paged_prefill_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None, table.data_ptr(),
            cache_len.data_ptr(), length.data_ptr(), out.data_ptr(),
            s, hq, hkv, n_pages, page_size, table.shape[0], d, scale,
            _DTYPES[q.dtype], int(quant),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    variant = "int8" if quant else "float"
    if err:
        raise RuntimeError(
            f"paged_prefill ({variant}) kernel launch failed: CUDA error "
            f"{err}")
    _build.count_launch("paged_prefill", variant)
    return out


def paged_prefill_ref(q, k_pages, v_pages, block_table, cache_len, length,
                      *, scale=None):
    """Plain PyTorch version, in JAX's form: the sequence's page timeline
    gathered to [capacity, hkv, d] (int8 pairs dequantized in f32 right
    after the gather, as ``_gather_context``), GQA heads repeated, then
    f32 scores over every position masked to ``c <= cache_len + t``,
    softmax and the product with V, cast back to q's dtype. Fixed-shape
    and free of host syncs (``length`` is not read: padded rows see the
    same mask, as in JAX)."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    s, hq, d = q.shape
    hkv, _, page_size, _ = kq.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    table = block_table.long()
    capacity = table.shape[0] * page_size

    def gather(pages, scales):
        g = pages[:, table]                            # [hkv, P, page, d]
        if scales is not None:
            g = g.float() * scales[:, table][..., None]
        g = g.reshape(hkv, capacity, d).float()
        if hkv != hq:
            g = g.repeat_interleave(hq // hkv, dim=0)
        return g                                       # [hq, C, d]

    k, v = gather(kq, ks), gather(vq, vs)
    qf = q.transpose(0, 1).float()                     # [hq, S, d]
    scores = torch.einsum("hsd,hcd->hsc", qf, k) * scale
    pos = torch.as_tensor(cache_len, device=q.device).reshape(()) + \
        torch.arange(s, device=q.device)
    keep = torch.arange(capacity, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~keep[None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hsc,hcd->hsd", probs, v)
    return out.transpose(0, 1).to(q.dtype)
