"""Continuation (paged-context) prefill attention, one sequence or a
batch of slots per launch.

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

The batched form adds a leading slot dimension to q, the table and the
two scalars — q [slots, S, hq, d], block_table [slots, P], cache_len and
length [slots] — and computes the same per slot, each over its own
table at its own offset: the speculative verify window (a K+1-token
continuation per batch slot, JAX ``adapter.py:493-556``). A slot with
``length`` 0 (inactive, or all padding) gives finite rows that are never
read; the kernel writes zeros there and reads no page.

In the JAX package this is XLA, not a TPU kernel: ``_gather_context``
(:246) or ``_gather_context_batch`` (:232) then the masked ``_sdpa``
(:428-432, :544). ``paged_prefill`` launches the hand-written kernel
``csrc/paged_prefill.cu`` on CUDA tensors, once for all slots (counted
``paged_prefill``, variant ``float`` or ``int8``): its grid is fixed by
S, the heads and the slots, and it reads ``cache_len`` and ``length``
from device memory, so one CUDA graph replays any chunk or window at any
offsets. CPU tensors take the plain version ``paged_prefill_ref`` (a
gather of the context, then the masked product; fixed-shape and free of
host syncs, like the kernel), which the serving adapter also runs by
name when its ``decode_kernel`` is ``"xla"``.
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
            [vp] * 9 + [ci] * 8 + [ctypes.c_float, ci, ci, vp])
        lib.paged_prefill_launch.restype = ci
        _lib = lib
    return _lib


def _check(q, kq, ks, vq, vs, block_table, cache_len, length):
    if (ks is None) != (vs is None):
        raise ValueError(
            "paged_prefill: k and v pages must both be int8 (pages, scales) "
            "pairs or both float tensors")
    if q.dim() not in (3, 4) or kq.dim() != 4 or vq.shape != kq.shape:
        raise ValueError(
            f"paged_prefill: want q [S, hq, d] or [slots, S, hq, d] and k/v "
            f"pages [hkv, pages, page_size, d], got {tuple(q.shape)}, "
            f"{tuple(kq.shape)}, {tuple(vq.shape)}")
    hq, d = q.shape[-2], q.shape[-1]
    if hq % kq.shape[0] or kq.shape[3] != d:
        raise ValueError(
            f"paged_prefill: q heads {hq} / head_dim {d} do not fit pages "
            f"{tuple(kq.shape)}")
    if q.dim() == 3:
        if block_table.dim() != 1:
            raise ValueError("paged_prefill: block_table must be [P]")
        if cache_len.numel() != 1 or length.numel() != 1:
            raise ValueError(
                "paged_prefill: cache_len and length must be scalars")
    else:
        slots = q.shape[0]
        if block_table.dim() != 2 or block_table.shape[0] != slots:
            raise ValueError(
                f"paged_prefill: block_table must be [slots={slots}, P], "
                f"got {tuple(block_table.shape)}")
        if cache_len.shape != (slots,) or length.shape != (slots,):
            raise ValueError(
                f"paged_prefill: cache_len and length must be [slots="
                f"{slots}], got {tuple(cache_len.shape)}, "
                f"{tuple(length.shape)}")
    if ks is not None:
        if kq.dtype != torch.int8 or vq.dtype != torch.int8:
            raise TypeError("paged_prefill: quantized pages must be int8")
        if ks.shape != kq.shape[:3] or vs.shape != kq.shape[:3]:
            raise ValueError(
                "paged_prefill: scales must be [hkv, pages, page_size]")


def paged_prefill(q, k_pages, v_pages, block_table, cache_len, length, *,
                  scale=None):
    """Continuation attention -> q's shape ([S, num_q_heads, head_dim],
    or [slots, S, num_q_heads, head_dim] batched) in q's dtype (see the
    module). CUDA tensors launch ``csrc/paged_prefill.cu`` once for all
    slots (float32, bfloat16 or float16 q; pages of q's dtype or int8
    pairs; head_dim 16, 32, 64, 128 or 256); CPU tensors run
    ``paged_prefill_ref``."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    _check(q, kq, ks, vq, vs, block_table, cache_len, length)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.dim() == 3:
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
    if block_table.shape[-1] > MAX_PAGES_PER_SEQ:
        raise ValueError(
            f"paged_prefill kernel: a block table of {block_table.shape[-1]} "
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
    one = q.dim() == 3
    q = (q[None] if one else q).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    out = _launch(q, kq, vq, ks, vs,
                  block_table.to(torch.int32).reshape(q.shape[0], -1)
                  .contiguous(),
                  cache_len.to(torch.int32).reshape(-1).contiguous(),
                  length.to(torch.int32).reshape(-1).contiguous(),
                  float(scale))
    return out[0] if one else out


def _launch(q, kq, vq, ks, vs, table, cache_len, length, scale):
    """The kernel on checked inputs (q [slots, S, hq, d] contiguous and
    16-byte aligned; int32 table [slots, P], cache_len and length
    [slots], contiguous) -> out in q's dtype, counted. ``chip_smoke.py``
    times this alone, without the wrapper's checks."""
    quant = ks is not None
    out = torch.empty_like(q)
    slots, s, hq, d = q.shape
    hkv, n_pages, page_size, _ = kq.shape
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.paged_prefill_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None, table.data_ptr(),
            cache_len.data_ptr(), length.data_ptr(), out.data_ptr(),
            slots, s, hq, hkv, n_pages, page_size, table.shape[1], d, scale,
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
    """Plain PyTorch version, in JAX's form: each slot's page timeline
    gathered to [capacity, hkv, d] (int8 pairs dequantized in f32 right
    after the gather, as ``_gather_context`` / ``_gather_context_batch``),
    then f32 scores over every position masked to ``c <= cache_len + t``,
    softmax and the product with V, cast back to q's dtype. Fixed-shape
    and free of host syncs (``length`` is not read: padded rows and
    inactive slots see the same mask, as in JAX).

    The two forms reduce as the step each one stands in for does, so the
    plain CPU paths agree bit for bit where JAX's do: a chunk ([S, hq,
    d]) takes every row in one product per head, as one-shot prefill's
    attention does (``prefill_ext`` chunks give one shot's logits); a
    batched window ([slots, S, hq, d]) takes each row alone in the
    grouped form of ``paged_attention_ref``, so a verify window's row 0
    is the decode step's attention for the same token."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dim() == 3:
        return _chunk_ref(q, kq, ks, vq, vs, block_table, cache_len, scale)
    return _window_ref(q, kq, ks, vq, vs, block_table, cache_len, scale)


def _gather(pages, scales, table):
    """[hkv, N, page, d] pages through table [b, P] -> [b, hkv, C, d] f32
    (int8 dequantized right after the gather)."""
    hkv, _, page_size, d = pages.shape
    b, n_pages = table.shape
    g = pages[:, table]                                 # [hkv, b, P, page, d]
    if scales is not None:
        g = g.float() * scales[:, table][..., None]
    return g.reshape(hkv, b, n_pages * page_size, d).transpose(0, 1).float()


def _chunk_ref(q, kq, ks, vq, vs, block_table, cache_len, scale):
    s, hq, d = q.shape
    hkv = kq.shape[0]
    table = block_table.long()[None]
    k, v = _gather(kq, ks, table)[0], _gather(vq, vs, table)[0]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=0)
        v = v.repeat_interleave(hq // hkv, dim=0)   # [hq, C, d]
    capacity = k.shape[1]
    qf = q.transpose(0, 1).float()                     # [hq, S, d]
    scores = torch.einsum("hsd,hcd->hsc", qf, k) * scale
    pos = torch.as_tensor(cache_len, device=q.device).reshape(()) + \
        torch.arange(s, device=q.device)
    keep = torch.arange(capacity, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~keep[None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hsc,hcd->hsd", probs, v)
    return out.transpose(0, 1).to(q.dtype)


def _window_ref(q, kq, ks, vq, vs, block_tables, cache_len, scale):
    b, s, hq, d = q.shape
    hkv = kq.shape[0]
    group = hq // hkv
    table = block_tables.long()
    k, v = _gather(kq, ks, table), _gather(vq, vs, table)   # [b, hkv, C, d]
    capacity = k.shape[2]
    # each row alone: [b, S, hkv] products of [group, d] by [d, C]
    qg = q.reshape(b, s, hkv, group, d).float()
    scores = torch.matmul(qg, k.transpose(-1, -2)[:, None]) * scale
    pos = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1) + \
        torch.arange(s, device=q.device)                # [b, S]
    keep = (torch.arange(capacity, device=q.device)[None, None, :]
            <= pos[:, :, None])                         # [b, S, C]
    scores = scores.masked_fill(~keep[:, :, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, v[:, None])               # [b, S, hkv, g, d]
    return out.reshape(b, s, hq, d).to(q.dtype)
