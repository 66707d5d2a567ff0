"""The split design of the continuation kernel (``kernels.paged_prefill``,
``csrc/paged_prefill.cu``) on the CPU, where the kernel cannot run:

* its geometry (``split_geometry``, ``split_range``): every key tile, so
  every key position below the capacity, falls in exactly one split of
  a row tile's cluster; the row tile is sized to the packed rows; the
  grid depends on the shapes and the capacity, never on ``cache_len`` or
  ``length``; the design each shape takes (``design_for``);
* a plain emulation of the kernel's split-and-merge (packed rows, row
  tiles, key tiles split over the cluster's blocks and each block's key
  slices, partial (max, sum, accumulator) states by online softmax,
  merged by their maxima) equal to ``paged_prefill_ref`` within atol
  1e-5 in float32 (the same products, summed in another order), in the
  chunk and the window forms, GQA at hq 8 / hkv 2, int8 pages, a slot of
  length 0 (finite zeros);
* both equal to JAX's ``_gather_context`` / ``_gather_context_batch``
  then the masked ``_sdpa`` on the same numpy inputs within atol 2e-5
  (two frameworks' f32 products).

The kernel itself is held to ``paged_prefill_ref`` on the card by
``chip_smoke.py`` (both designs, every case).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import paged_attention as jpa
from paddle_tpu.ops.impl.nn_ops import scaled_dot_product_attention as jsdpa
from paddle_tpu.serving.adapter import _gather_context, _gather_context_batch
from paddle_tpu_torch.kernels import _build, launch_counts
from paddle_tpu_torch.kernels import paged_prefill as ppf
from paddle_tpu_torch.kernels.paged_attention import split_pages

REF_TOL = dict(rtol=0, atol=1e-5)
JAX_TOL = dict(rtol=0, atol=2e-5)


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("capacity", [16, 64, 80, 512, 1000])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_every_key_falls_in_exactly_one_split(capacity, splits):
    cap_tiles = -(-capacity // ppf.KEY_TILE)
    for n_tiles in range(cap_tiles + 1):      # every k_end up to capacity
        owner = [[] for _ in range(n_tiles)]
        for rank in range(splits):
            lo, hi = ppf.split_range(rank, splits, n_tiles)
            assert 0 <= lo <= hi <= n_tiles
            for kt in range(lo, hi):
                owner[kt].append(rank)
        assert all(len(o) == 1 for o in owner)
        # balanced: no block takes more than one tile above another
        sizes = [np.subtract(*ppf.split_range(r, splits, n_tiles)[::-1])
                 for r in range(splits)]
        assert max(sizes) - min(sizes) <= 1
    # at the capacity, the tiles cover every key position once
    keys = np.zeros(capacity, int)
    for rank in range(splits):
        lo, hi = ppf.split_range(rank, splits, cap_tiles)
        for kt in range(lo, hi):
            keys[kt * ppf.KEY_TILE:(kt + 1) * ppf.KEY_TILE] += 1
    assert (keys == 1).all()


@pytest.mark.parametrize("slots,s,hq,hkv,want_rows", [
    (8, 5, 16, 16, 16),     # the serving verify window
    (8, 5, 32, 4, 64),      # GQA window: 8 heads x 5 rows packed
    (8, 5, 8, 2, 32),       # 4 heads x 5 rows
    (1, 16, 16, 16, 16),    # a chunk bucket of 16
    (1, 128, 16, 16, 64),   # a 128-token chunk
    (1, 128, 32, 4, 64),
])
def test_row_tiles_are_sized_to_the_packed_rows(slots, s, hq, hkv,
                                                want_rows):
    rows, row_tiles, splits, stages = ppf.split_geometry(
        slots, s, hq, hkv, 512, 64, False, lambda depth, n: 264)
    group = hq // hkv
    assert rows == want_rows
    assert row_tiles == -(-s * group // rows)
    assert (row_tiles - 1) * rows < s * group <= row_tiles * rows
    assert splits in (1, 2, 4) and splits <= ppf.MAX_SPLITS
    # one wave: the grid's blocks fit the resident count where splits > 1
    assert splits == 1 or splits * slots * hkv * row_tiles <= 264
    assert ppf.SPLIT_STAGES <= stages <= ppf.MAX_STAGES


def _geometry(slots, s, hq, hkv, capacity, resident, d=64, quant=False,
              deep=None):
    """split_geometry with ``resident`` blocks at the usual ring depth and
    ``deep`` (default: the same) at the deepest, whatever the clusters."""
    return ppf.split_geometry(
        slots, s, hq, hkv, capacity, d, quant,
        lambda depth, n: resident if depth == ppf.SPLIT_STAGES
        else (resident if deep is None else deep))


def test_splits_follow_capacity_and_room():
    # 16 (slot, kv head) row tiles, room for 16 blocks each: 4 at most
    assert _geometry(1, 16, 16, 16, 512, 264)[2] == 4
    # the capacity's key tiles bound it
    assert _geometry(1, 16, 16, 16, 128, 264)[2] == 2
    assert _geometry(1, 16, 16, 16, 16, 264)[2] == 1
    # a grid that fills the card takes one
    assert _geometry(8, 128, 16, 16, 512, 264)[2] == 1
    # room for 3 a row tile: a power of two below it
    assert _geometry(8, 5, 16, 16, 512, 3 * 128)[2] == 2
    # clusters the card places at once bound it too (a cluster's blocks
    # share a GPC): room for 2-block clusters, not 4-block ones
    assert ppf.split_geometry(
        1, 16, 16, 16, 512, 128, False,
        lambda depth, n: 48 if n == 4 else 264)[2] == 2
    # the serving cells: verify 2, GQA verify 4, a 16-token chunk 4
    assert _geometry(8, 5, 16, 16, 512, 264, d=128)[2:] == (2, 3)
    assert _geometry(8, 5, 32, 4, 512, 528)[2:] == (4, 3)
    assert _geometry(1, 16, 16, 16, 512, 264, d=128)[2:] == (4, 3)


def test_64_row_tiles_at_d128_over_16_bit_pages_take_one_split():
    # measured: their 64 x 128 f32 merged state costs more to push than
    # the split saves; int8 pages (converted per tile) still split
    assert _geometry(1, 128, 16, 16, 512, 264, d=128)[2] == 1
    assert _geometry(1, 128, 16, 16, 512, 264, d=128, quant=True)[2] == 4
    assert _geometry(1, 128, 32, 4, 512, 528, d=64)[2] == 4
    # one split and a grid within one block an SM: the deepest ring
    assert _geometry(1, 128, 16, 16, 512, 264, d=128, deep=132)[3] == 6
    # ... not past the capacity's key tiles, nor past one wave
    assert _geometry(1, 128, 16, 16, 256, 264, d=128, deep=132)[3] == 4
    assert _geometry(8, 128, 16, 16, 512, 264, d=128, deep=132)[3] == 3


def test_grid_depends_on_neither_cache_len_nor_length(monkeypatch):
    # the wrapper's launch on a stand-in library: the grid arguments it
    # passes (rows, splits) are the same for every cache_len and length
    calls = []

    class Lib:
        @staticmethod
        def paged_prefill_launch(*args):
            calls.append(args[9:17] + args[18:24])
            return 0

    monkeypatch.setattr(ppf, "_kernel", lambda: Lib)
    monkeypatch.setattr(ppf, "_resident_blocks", lambda *a: 264)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    q = torch.zeros(3, 5, 8, 64, dtype=torch.bfloat16)
    pages = torch.zeros(2, 20, 16, 64, dtype=torch.bfloat16)
    table = torch.zeros(3, 8, dtype=torch.int32)
    _build.reset_launch_counts()
    for cl, ln in [(0, 5), (100, 1), (123, 0), (7, 3)]:
        ppf._launch(q, pages, pages, None, None, table,
                    torch.full((3,), cl, dtype=torch.int32),
                    torch.full((3,), ln, dtype=torch.int32), 0.125)
    assert len(set(calls)) == 1
    (args,) = set(calls)
    assert args[-4:-1] == (1, 32, 2)   # design split, 32 rows, 2 splits
    assert launch_counts()["paged_prefill"] == 4
    assert _build.variant_counts() == {"paged_prefill/float": 4,
                                       "paged_prefill/split": 4}
    _build.reset_launch_counts()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("dtype,d,page,design,want", [
    (torch.bfloat16, 128, 16, None, "split"),
    (torch.float16, 64, 8, None, "split"),
    (torch.bfloat16, 128, 128, None, "split"),
    (torch.bfloat16, 128, 16, "ring", "ring"),
    (torch.bfloat16, 32, 16, None, "ring"),     # head dim: the ring
    (torch.bfloat16, 128, 5, None, "ring"),     # odd page size
    (torch.bfloat16, 128, 24, None, "ring"),    # does not divide 64
    (torch.float32, 128, 16, None, "fma"),
    (torch.float32, 128, 16, "ring", "fma"),
])
def test_each_shape_names_its_design(dtype, d, page, design, want):
    assert ppf.design_for(dtype, d, page, design) == want


def test_a_design_that_cannot_run_raises():
    with pytest.raises(ValueError, match="split design takes"):
        ppf.design_for(torch.bfloat16, 32, 16, "split")
    with pytest.raises(ValueError, match="design must be"):
        ppf.design_for(torch.bfloat16, 128, 16, "wgmma")
    pages = torch.zeros(2, 5, 4, 16)
    q, table = torch.zeros(8, 4, 16), torch.zeros(4, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="design must be"):
        ppf.paged_prefill(q, pages, pages, table, zero, zero, design="x")


# ------------------------------------------------ split-and-merge emulation
def _timeline(pages, scales, table, kvh):
    """Kv head ``kvh``'s page timeline [capacity, d] f32 through
    ``table`` (int8 dequantized; an entry outside the pool: zeros)."""
    n_pages, page, d = pages.shape[1:]
    rows = []
    for phys in table.tolist():
        if 0 <= phys < n_pages:
            x = pages[kvh, phys].float()
            if scales is not None:
                x = x * scales[kvh, phys][:, None]
        else:
            x = torch.zeros(page, d)
        rows.append(x)
    return torch.cat(rows)


def _merge(parts):
    """Partial (max, sum, accumulator) states over disjoint keys -> one,
    weighted by exp(max - the largest max); a part with no visible key
    (max -inf) weighs nothing."""
    mx = torch.stack([x[0] for x in parts]).max(dim=0).values
    lsum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.where(m == float("-inf"), torch.zeros_like(m),
                        torch.exp(m - mx))
        lsum = lsum + w * l
        acc = acc + w[:, None] * a
    return mx, lsum, acc


def emulate_split(q, k_pages, v_pages, tables, cache_len, length, resident):
    """The split design's arithmetic in plain f32 PyTorch: q [slots, S,
    hq, d]; the geometry from ``split_geometry``; per (slot, kv head, row
    tile) the key tiles to ``cache_len`` + the tile's last token + 1
    split over the cluster (``split_range``) and each 64-key tile over
    the block's key slices; each (split, slice) part an online softmax
    over its keys; a block's slices merged by their maxima, then the
    cluster's blocks."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    slots, s, hq, d = q.shape
    hkv, _, page, _ = kq.shape
    group = hq // hkv
    capacity = tables.shape[1] * page
    rows, row_tiles, splits, _ = ppf.split_geometry(
        slots, s, hq, hkv, capacity, d, ks is not None,
        lambda depth, n: resident)
    # the warps sharing a 16-row group (csrc SplitCfg::kKW)
    n_slices = 4 if rows == 16 else (2 if rows == 32 or d == 64 else 1)
    slice_keys = ppf.KEY_TILE // n_slices
    scale = 1.0 / math.sqrt(d)
    out = torch.full(q.shape, float("nan"))
    for sl in range(slots):
        cl = max(int(cache_len[sl]), 0)
        ln = min(max(int(length[sl]), 0), s)
        for kvh in range(hkv):
            k = _timeline(kq, ks, tables[sl], kvh)
            v = _timeline(vq, vs, tables[sl], kvh)
            for rt in range(row_tiles):
                p = torch.arange(rt * rows, min((rt + 1) * rows, s * group))
                tok, head = p // group, kvh * group + p % group
                if rt * rows // group >= ln:      # padding only: zeros
                    out[sl, tok, head] = 0.0
                    continue
                qr = q[sl, tok, head].float()                 # [R, d]
                see = cl + tok                                # last key
                k_end = min(cl + min(int(tok[-1]) + 1, ln), capacity)
                n_tiles = -(-k_end // ppf.KEY_TILE)
                blocks = []
                for rank in range(splits):
                    lo, hi = ppf.split_range(rank, splits, n_tiles)
                    slices = []
                    for kw in range(n_slices):
                        m = torch.full((len(p),), float("-inf"))
                        lsum = torch.zeros(len(p))
                        acc = torch.zeros(len(p), d)
                        for kt in range(lo, hi):
                            keys = (kt * ppf.KEY_TILE + kw * slice_keys
                                    + torch.arange(slice_keys))
                            inside = keys < capacity
                            kk = k[keys.clamp(max=capacity - 1)]
                            vv = v[keys.clamp(max=capacity - 1)]
                            sc = qr @ kk.T * scale
                            keep = ((keys < k_end) & inside)[None] & \
                                (keys[None] <= see[:, None])
                            sc = sc.masked_fill(~keep, float("-inf"))
                            m_new = torch.maximum(m, sc.max(dim=1).values)
                            base = torch.where(m_new == float("-inf"),
                                               torch.zeros_like(m_new), m_new)
                            pr = torch.exp(sc - base[:, None])
                            alpha = torch.exp(m - base)
                            lsum = lsum * alpha + pr.sum(dim=1)
                            acc = acc * alpha[:, None] + pr @ vv
                            m = m_new
                        slices.append((m, lsum, acc))
                    blocks.append(_merge(slices))   # the block's key slices
                m, lsum, acc = _merge(blocks)       # the cluster's blocks
                inv = torch.where(lsum == 0, torch.zeros_like(lsum),
                                  1.0 / lsum)
                out[sl, tok, head] = acc * inv[:, None]
    assert not torch.isnan(out).any()      # every row written
    return out


def _pages(rng, hkv, n_pages, page, d, quant):
    """(JAX entry, port entry) of one layer: the same pages, the port's
    with its sink page."""
    x = rng.randn(hkv, n_pages, page, d).astype(np.float32)
    if not quant:
        sink = np.zeros((hkv, 1, page, d), np.float32)
        return jnp.asarray(x), torch.from_numpy(
            np.concatenate([x, sink], axis=1))
    q8, sc = (np.asarray(a) for a in jpa.quantize_tokens(jnp.asarray(x)))
    port = (torch.from_numpy(np.concatenate(
                [q8, np.zeros((hkv, 1, page, d), np.int8)], axis=1)),
            torch.from_numpy(np.concatenate(
                [sc, np.zeros((hkv, 1, page), np.float32)], axis=1)))
    return (jnp.asarray(q8), jnp.asarray(sc)), port


def _jax_masked(gather, jk, jv, tables, q, cache_len, hq, hkv, page):
    """JAX's form: the context gathered through the tables, then the
    masked ``_sdpa`` over every position ``<= cache_len + t``."""
    kc, vc = gather(jk, jnp.asarray(tables)), gather(jv, jnp.asarray(tables))
    if gather is _gather_context:
        kc, vc = kc[None], vc[None]
    if hkv != hq:
        kc = jnp.repeat(kc, hq // hkv, axis=2)
        vc = jnp.repeat(vc, hq // hkv, axis=2)
    capacity = tables.shape[-1] * page
    pos = np.reshape(cache_len, (-1, 1)) + np.arange(q.shape[-3])[None]
    keep = np.arange(capacity)[None, None] <= pos[:, :, None]
    qb = q if q.ndim == 4 else q[None]
    return np.asarray(jsdpa(jnp.asarray(qb), kc, vc,
                            jnp.asarray(keep)[:, None]))


QUANT = pytest.mark.parametrize("quant", [False, True],
                                ids=["float", "int8"])
HEADS = pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)],
                                ids=["mha", "gqa8_2"])
# resident blocks: a full card's worth (splits up to the capacity's key
# tiles) and one block a row tile (no split)
RESIDENT = pytest.mark.parametrize("resident", [4096, 1],
                                   ids=["split", "one"])


@QUANT
@HEADS
@RESIDENT
@pytest.mark.parametrize("cache_len,length", [(0, 24), (37, 20), (130, 9),
                                              (200, 1)])
def test_chunk_split_and_merge_matches_ref_and_jax(quant, hq, hkv, resident,
                                                   cache_len, length):
    # one sequence, a 24-row bucket (a chunk of S > 16: 32- or 64-row
    # tiles), page 16, a 16-page table (capacity 256: 4 key tiles)
    rng = np.random.RandomState(cache_len * 7 + length + hq + quant)
    page, d, s, n_pages = 16, 16, 24, 20
    jk, tk = _pages(rng, hkv, n_pages, page, d, quant)
    jv, tv = _pages(rng, hkv, n_pages, page, d, quant)
    table = rng.permutation(n_pages)[:16].astype(np.int32)
    q = rng.randn(s, hq, d).astype(np.float32)
    cl = torch.tensor(cache_len, dtype=torch.int32)
    ln = torch.tensor(length, dtype=torch.int32)
    ref = ppf.paged_prefill_ref(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(table), cl, ln)
    got = emulate_split(torch.from_numpy(q)[None], tk, tv,
                        torch.from_numpy(table)[None], cl.reshape(1),
                        ln.reshape(1), resident)[0]
    assert bool(got.isfinite().all())
    torch.testing.assert_close(got[:length], ref[:length], **REF_TOL)
    jref = _jax_masked(_gather_context, jk, jv, table, q, cache_len, hq,
                       hkv, page)[0]
    np.testing.assert_allclose(got[:length].numpy(), jref[:length],
                               **JAX_TOL)
    np.testing.assert_allclose(ref[:length].numpy(), jref[:length],
                               **JAX_TOL)


@QUANT
@HEADS
@RESIDENT
def test_window_split_and_merge_matches_ref_and_jax(quant, hq, hkv,
                                                    resident):
    # the verify window: six slots of S = 5 rows at positions spread over
    # the table (one window reaching its end), an inactive slot (length
    # 0) and a one-row window
    rng = np.random.RandomState(hq + 5 * hkv + quant + resident % 7)
    page, d, s, n_pages = 16, 16, 5, 40
    jk, tk = _pages(rng, hkv, n_pages, page, d, quant)
    jv, tv = _pages(rng, hkv, n_pages, page, d, quant)
    tables = np.stack([rng.permutation(n_pages)[:8]
                       for _ in range(6)]).astype(np.int32)  # capacity 128
    cache_len = np.array([0, 37, 64, 90, 123, 50], np.int32)
    length = np.array([5, 3, 5, 0, 5, 1], np.int32)
    q = rng.randn(6, s, hq, d).astype(np.float32)
    args = (tk, tv, torch.from_numpy(tables), torch.from_numpy(cache_len),
            torch.from_numpy(length))
    ref = ppf.paged_prefill_ref(torch.from_numpy(q), *args)
    got = emulate_split(torch.from_numpy(q), *args, resident)
    assert bool(got.isfinite().all())
    assert torch.equal(got[3], torch.zeros_like(got[3]))   # length 0
    jref = _jax_masked(_gather_context_batch, jk, jv, tables, q, cache_len,
                       hq, hkv, page)
    for i, n in enumerate(length):
        torch.testing.assert_close(got[i, :n], ref[i, :n], **REF_TOL)
        np.testing.assert_allclose(got[i, :n].numpy(), jref[i, :n],
                                   **JAX_TOL)
        np.testing.assert_allclose(ref[i, :n].numpy(), jref[i, :n],
                                   **JAX_TOL)


def test_window_geometry_of_the_emulated_cases_splits_and_slices():
    # the window cases above run 16-row tiles with 4 key slices (mha) and
    # 32-row tiles with 2 (gqa, 4 heads x 5 rows), over 2 splits (the
    # 128-token capacity's key tiles); the chunk cases 32- or 64-row
    # tiles over up to 4 splits
    assert _geometry(6, 5, 4, 4, 128, 4096, d=16)[:3] == (16, 1, 2)
    assert _geometry(6, 5, 8, 2, 128, 4096, d=16)[:3] == (32, 1, 2)
    assert _geometry(1, 24, 4, 4, 256, 4096, d=16)[:3] == (32, 1, 4)
    assert _geometry(1, 24, 8, 2, 256, 4096, d=16)[:3] == (64, 2, 4)
