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
``csrc/paged_prefill.cu`` on CUDA tensors, once for all slots: its grid
is fixed by S, the heads, the slots and the table's capacity, and it
reads ``cache_len`` and ``length`` from device memory, so one CUDA graph
replays any chunk or window at any offsets. CPU tensors take the plain
version ``paged_prefill_ref`` (a gather of the context, then the masked
product; fixed-shape and free of host syncs, like the kernel), which the
serving adapter also runs by name when its ``decode_kernel`` is
``"xla"``.

What bounds it on an H100 is latency, not bytes or operations: a verify
window of the serving cell moves ~13 MB (~4 us), a 128-token chunk ~3.6
MB (~1 us), but one block walking a (query tile, head)'s key tiles one
after the other takes ~10x that: a block waits on its chain of
dependent steps (its table, then its tiles, then the products).
The kernel has two designs for 16-bit q
(``design_for``), each launch counted under ``paged_prefill``, its page
variant (``float`` or ``int8``) and its design:

* ``split`` (the default): a block takes 16, 32 or 64 packed query rows
  of one (slot, kv head) (``split_geometry``: a window's S x group rows,
  under GQA the group's query heads packed into the rows so each K/V row
  is read once per kv head), its warps split each 64-key tile, and the
  key tiles are split over a thread-block cluster of up to 4 blocks
  (``split_range``): the warps' partial softmax states are merged in the
  block, the blocks' through distributed shared memory. Pages come in
  by TMA into a ring of 3 stages (6 when one split leaves the grid
  small). It takes d 64 and 128 and page sizes that are multiples of 8
  dividing 64 or multiples of 64; its 64-row tiles at d 128 with bf16 q
  run QK^T and PV on wgmma, the rest on mma.sync.
* ``ring``: the first design (one block per 64-row query tile and head
  walking every key tile through a ``cp.async`` ring), for the head dims
  and page sizes ``split`` does not take, and by request
  (``design="ring"``) for side-by-side timing.
* ``fma``: f32 q, exact f32 FMAs (off the serving path), whichever design
  is asked for.

Measured by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at a 700 W
power limit (kernel alone, median of 20 launches, cold L2), split against
ring in the same run: the serving verify window (8 slots x 5 rows, 16
heads, d 128) 0.0217 against 0.0369 ms; a 16-token chunk after 496
cached tokens 0.0155 against 0.0372; a 128-token chunk after 192 cached
0.0199 against 0.0265; the rest in ``PERF.md``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import split_pages

__all__ = ["paged_prefill", "paged_prefill_ref", "HEAD_DIMS", "DESIGNS",
           "design_for", "split_geometry", "split_range"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)
# the ring kernel keeps the block table in shared memory beside its
# tiles: 8192 entries fit at every head dim
MAX_PAGES_PER_SEQ = 8192
# device kernels, as counted ("paged_prefill/<design>")
DESIGNS = ("split", "ring", "fma")
_DESIGN_IDS = {"split": 1, "ring": 0, "fma": 0}
# the split design: keys a ring stage (and a tile of the range split),
# head dims it takes, blocks a cluster at most (csrc: kMaxSplits)
KEY_TILE = 64
SPLIT_HEAD_DIMS = (64, 128)
MAX_SPLITS = 4
SPLIT_STAGES, MAX_STAGES = 3, 6    # ring stages: usual, deepest (csrc)
_lib = None
_resident: dict = {}


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_prefill")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_prefill_launch.argtypes = (
            [vp] * 9 + [ci] * 8 + [ctypes.c_float] + [ci] * 6 + [vp])
        lib.paged_prefill_launch.restype = ci
        lib.paged_prefill_split_occupancy.argtypes = [ci] * 7
        lib.paged_prefill_split_occupancy.restype = ci
        _lib = lib
    return _lib


def design_for(dtype, head_dim, page_size, design=None):
    """The device kernel a launch takes (``DESIGNS``): ``"fma"`` for f32
    q, whatever ``design`` asks; for 16-bit q ``"split"`` where it takes
    the head dim and page size, else ``"ring"``; ``design="ring"`` asks
    for the first design, ``design="split"`` raises on a shape it does
    not take."""
    if design not in (None, "split", "ring"):
        raise ValueError(f"paged_prefill: design must be None, 'split' or "
                         f"'ring', got {design!r}")
    if dtype == torch.float32:
        return "fma"
    if design == "ring":
        return "ring"
    if (head_dim in SPLIT_HEAD_DIMS and page_size % 8 == 0
            and (KEY_TILE % page_size == 0 or page_size % KEY_TILE == 0)):
        return "split"
    if design == "split":
        raise ValueError(
            f"paged_prefill: the split design takes head_dim "
            f"{SPLIT_HEAD_DIMS} and page sizes that are multiples of 8 "
            f"dividing {KEY_TILE} or multiples of it, got head_dim "
            f"{head_dim}, page_size {page_size}")
    return "ring"


def split_rows(s, group):
    """Packed query rows a block of the split design takes: 16, 32 or 64,
    the least that holds a window's ``s`` x ``group`` rows."""
    packed = s * group
    return 16 if packed <= 16 else (32 if packed <= 32 else 64)


def split_geometry(slots, s, heads, kv_heads, capacity, head_dim, quant,
                   resident):
    """(rows, row_tiles, splits, stages) of a split-design launch: ``rows``
    packed (token, query head of the group) rows a block, ``row_tiles``
    tiles of them per (slot, kv head), ``splits`` blocks a cluster
    sharing a row tile's key tiles and ``stages`` ring stages.
    ``resident(stages, splits)`` is how many blocks the card holds at
    once at that ring depth in clusters of ``splits``. The grid is
    (splits, row_tiles x kv_heads, slots): fixed by the shapes and the
    capacity, never by ``cache_len`` or ``length``.

    ``splits`` is the largest power of two, at most ``MAX_SPLITS`` and the
    capacity's key tiles, whose grid the card holds in one wave; but one
    where a block's merged state is a 64-row x 128 f32 tile over 16-bit
    pages (pushing it through the cluster cost more than the shorter key
    ranges saved at every such case on the H100: ``chip_sweeps.py
    prefill_split``).
    ``stages`` is ``SPLIT_STAGES``, or up to ``MAX_STAGES`` where one
    split leaves the grid within one wave at that depth."""
    group = heads // kv_heads
    rows = split_rows(s, group)
    row_tiles = -(-s * group // rows)
    pairs = slots * kv_heads * row_tiles
    cap_tiles = -(-capacity // KEY_TILE)
    most = 1 if (rows == 64 and head_dim == 128 and not quant) else \
        min(MAX_SPLITS, cap_tiles)
    splits = 1
    while (splits * 2 <= most
           and pairs * splits * 2 <= resident(SPLIT_STAGES, splits * 2)):
        splits *= 2
    stages = SPLIT_STAGES
    if splits == 1 and cap_tiles > stages and \
            pairs <= resident(MAX_STAGES, 1):
        stages = min(MAX_STAGES, cap_tiles)
    return rows, row_tiles, splits, stages


def split_range(rank, splits, n_tiles):
    """Key tiles [lo, hi) block ``rank`` of a cluster of ``splits`` takes
    when its row tile needs ``n_tiles`` (read from device memory at run
    time: ``cache_len`` + the tile's last token + 1, within the
    capacity); the kernel computes the same."""
    return rank * n_tiles // splits, (rank + 1) * n_tiles // splits


def _resident_blocks(device, d, dtype, quant, rows, stages, pages_per_seq,
                     splits):
    """Blocks of the split kernel the card holds at once in clusters of
    ``splits``, asked of the CUDA runtime once per shape."""
    key = (device, d, dtype, quant, rows, stages, pages_per_seq, splits)
    n = _resident.get(key)
    if n is None:
        with torch.cuda.device(device):
            n = _kernel().paged_prefill_split_occupancy(
                d, _DTYPES[dtype], int(quant), rows, stages, pages_per_seq,
                splits)
        if n < 0:   # 0: the card holds none (that ring depth won't fit)
            raise RuntimeError(
                f"paged_prefill (split) occupancy query failed: CUDA error "
                f"{-n}")
        _resident[key] = n
    return n


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
                  scale=None, design=None):
    """Continuation attention -> q's shape ([S, num_q_heads, head_dim],
    or [slots, S, num_q_heads, head_dim] batched) in q's dtype (see the
    module). CUDA tensors launch ``csrc/paged_prefill.cu`` once for all
    slots (float32, bfloat16 or float16 q; pages of q's dtype or int8
    pairs; head_dim 16, 32, 64, 128 or 256) on the kernel ``design_for``
    picks (``design="ring"``: the first design); CPU tensors run
    ``paged_prefill_ref``."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    _check(q, kq, ks, vq, vs, block_table, cache_len, length)
    design_for(q.dtype, q.shape[-1], kq.shape[2], design)   # a bad name raises
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
                  float(scale), design)
    return out[0] if one else out


def _launch(q, kq, vq, ks, vs, table, cache_len, length, scale,
            design=None):
    """The kernel on checked inputs (q [slots, S, hq, d] contiguous and
    16-byte aligned; int32 table [slots, P], cache_len and length
    [slots], contiguous) -> out in q's dtype, counted by page variant and
    design. ``chip_smoke.py`` times this alone, without the wrapper's
    checks."""
    quant = ks is not None
    out = torch.empty_like(q)
    slots, s, hq, d = q.shape
    hkv, n_pages, page_size, _ = kq.shape
    name = design_for(q.dtype, d, page_size, design)
    if name == "split" and any(t.data_ptr() % 16 for t in (
            (kq, vq, ks, vs) if quant else (kq, vq))):
        if design == "split":
            raise ValueError("paged_prefill: the split design reads pages "
                             "and scales starting on a 16-byte boundary")
        name = "ring"
    rows = splits = stages = 0
    if name == "split":
        rows = split_rows(s, hq // hkv)
        rows, _, splits, stages = split_geometry(
            slots, s, hq, hkv, table.shape[1] * page_size, d, quant,
            lambda depth, n: _resident_blocks(q.device, d, q.dtype, quant,
                                              rows, depth, table.shape[1], n))
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.paged_prefill_launch(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None, table.data_ptr(),
            cache_len.data_ptr(), length.data_ptr(), out.data_ptr(),
            slots, s, hq, hkv, n_pages, page_size, table.shape[1], d, scale,
            _DTYPES[q.dtype], int(quant), _DESIGN_IDS[name], rows, splits,
            stages, torch.cuda.current_stream(q.device).cuda_stream,
        )
    variant = "int8" if quant else "float"
    if err:
        raise RuntimeError(
            f"paged_prefill ({variant}, {name}) kernel launch failed: CUDA "
            f"error {err}")
    _build.count_launch("paged_prefill", variant, name)
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
