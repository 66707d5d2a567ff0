#!/usr/bin/env python3
"""Design sweeps of the port's Hopper kernels on one NVIDIA GPU.

    python3 chip_sweeps.py              # every sweep, one card

Each sweep builds variants of a kernel source from an edited copy of
``paddle_tpu_torch/kernels/csrc`` under ``build/sweeps/<variant>/`` (the
checkout is never edited), loads each variant in a process of its own and
times the wgmma kernel on the same inputs with CUDA events, cold L2, as
``chip_smoke.py`` does (``cuda_times``: [mean, median] of 20 launches),
holding every output to ``chip_smoke.GATE``. The variants run in turns
(a, b, a, b) so that a drift of the card shows.

A variant sets the value of marked declarations: a line of the source
``<declaration> = <value>;  // sweep: <key> ...`` gets a variant's value
for ``<key>`` in place of its own. Each key is on exactly one line of its
source (``tests/test_torch_build.py`` holds the sources to that), so a
reformatted line keeps its sweep.

Sweeps:

* ``flash_chunk``: the flash forward's block order: as built (one chunk
  where all of K and V fit in 24 MB, else chunks of (batch, head) pairs
  whose K and V take 8 MB), always 8 or 16 MB chunks, or always one chunk
  (the heaviest query tiles of every head first), at the training shape
  and at shapes whose K and V fit in L2;
* ``flash_stages``: its K/V ring at 2 and 3 stages (d 128);
* ``flash_bwd_stages``: the flash backward's dk/dv ring (Q/dO tiles) at
  2 and 3 stages (the dq ring has room for 2 only at d 128);
* ``flash_bwd_tile``: its tiles: the dk/dv query-tile height at 128
  where it is 64 (d 128: more registers) and the dq key-tile width at 64
  against 128, timed through ``_bwd`` (delta and both kernels);
* ``flash_bwd_tf32``: the f32 backward's 3xTF32 kernels (dq, dk/dv):
  32-row streamed tiles at d 128 (1 block an SM) against 16 (as built),
  and the d-64 dq kernel compiled for 3 blocks an SM (168 registers)
  against 2, each kernel alone and the whole backward, f32 inputs at the
  DiT, training and GQA shapes;
* ``gmm_tile``: the grouped GEMM's output tile 128 x 256
  (wgmma.m64n256k16) against 128 x 128;
* ``gmm_epilogue``: the grouped GEMM's output through a TMA store from
  shared memory against bf16 pairs stored straight from the registers;
* ``gmm_int8_stages``: the int8-rhs wgmma kernel's ring at 4 and 3 stages,
  and two product groups left in flight while it converts against one;
* ``gmm_crossover``: the wgmma and the mma.sync grouped GEMM side by side
  from the JAX sweep shape to the MoE layer's (the built sources as they
  are), bf16 rhs, its transposed instance (``trans_rhs``, the backward's
  ``dlhs``) and int8 rhs (at the widths the int8 wgmma kernel takes,
  m % 16 == 0), for ``grouped_matmul.WGMMA_MIN_MACS`` and
  ``INT8_WGMMA_MIN_MACS``, in two turns with the kernels' order swapped;
* ``wgrad_tile``: the weight-gradient wgmma kernel's ring depth (4
  stages with its output staged two boxes a round, against 3 stages with
  all four boxes or two, and 2) and output tile (128 x 256,
  wgmma.m64n256k16, against 128 x 128), at the MoE layer's up and down
  projections;
* ``wgrad_crossover``: the weight gradient's wgmma and mma.sync kernels
  side by side over the same shapes as ``gmm_crossover``, for
  ``grouped_matmul.WGRAD_WGMMA_MIN_MACS``, in two turns with the order
  swapped;
* ``prefill_split``: the continuation kernel's split design at forced
  geometries (splits 1, 2, 4 and 8 in a build whose clusters go to 8
  blocks; ring depth 3 and 6) beside the wrapper's choice and the ring
  design, at the chunk shapes and the serving cell's verify windows;
* ``prefill_slices``: its 64-row tiles at d 128 with one key slice (4
  warps, as built) against two (8 warps), at the chunk shapes;
* ``prefill_mma``: the continuation kernel's split design alone
  (``_launch``) with its 64-row tiles at d 128 on wgmma (as built) and on
  mma.sync, at the serving pool's chunk shapes, bf16 and int8 pages
  (the 16-row (496, 16) case, mma.sync in both, as a control);
* ``paged_cluster``: the cluster paged-decode kernel alone (``_launch``)
  at its tile and ring depth (32-token tiles in 2 or 3 stages, 16-token
  tiles in 4), cluster size (at most 4 or 8 blocks) and least chunk (64
  or 128 tokens), at the serving shape (bf16 and int8 pools, f32 q), GQA
  and long context. A variant the card refuses to launch is reported as
  its error.

The last line of the output is one JSON object with every time.
``--sweeps`` picks a subset. Without a CUDA device the script exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "paddle_tpu_torch", "kernels", "csrc")

# sweep: (source, {variant: {marker key: value}}); the first variant is
# the source as built
SWEEPS = {
    "flash_chunk": ("flash_attention", {
        "as_built": {},
        "always_8mb": {"flash_one_chunk_bytes": "0"},
        "always_16mb": {"flash_one_chunk_bytes": "0",
                        "flash_chunk_bytes": "16LL << 20"},
        "one_chunk": {"flash_one_chunk_bytes": "1LL << 62"},
    }),
    "flash_stages": ("flash_attention", {
        "stages_2": {},
        "stages_3": {"flash_stages": "3"},
    }),
    "flash_bwd_stages": ("flash_attention_bwd", {
        "stages_2": {},
        "stages_3": {"flash_bwd_stages": "3"},
    }),
    "flash_bwd_tile": ("flash_attention_bwd", {
        "as_built": {},
        "dkv_rows_128": {"flash_bwd_dkv_rows": "128"},
        "dq_keys_64": {"flash_bwd_dq_keys": "64"},
    }),
    "flash_bwd_tf32": ("flash_attention_bwd", {
        "as_built": {},
        "rows_32": {"flash_bwd_tf32_rows": "32"},
        "dq_3_blocks_d64": {"flash_bwd_tf32_dq_blocks": "D == 64 ? 3 : 2"},
    }),
    "gmm_tile": ("grouped_matmul", {
        "n256": {},
        "n128": {"gmm_tile_n": "128"},
    }),
    "gmm_epilogue": ("grouped_matmul", {
        "tma_store": {},
        "register_store": {"gmm_tma_store": "false"},
    }),
    "wgrad_tile": ("grouped_matmul_bwd", {
        "stages_4_out_2": {},
        "stages_3_out_4": {"wgrad_stages": "3", "wgrad_out_boxes": "4"},
        "stages_3_out_2": {"wgrad_stages": "3"},
        "stages_2": {"wgrad_stages": "2"},
        "n128": {"wgrad_tile_n": "128"},
    }),
    "gmm_int8_stages": ("grouped_matmul", {
        "stages_4": {},
        "stages_3": {"gmm_int8_stages": "3"},
        "depth_2": {"gmm_int8_depth": "2"},
    }),
    "prefill_mma": ("paged_prefill", {
        "wgmma": {},
        "mma_sync": {"prefill_wgmma": "false"},
    }),
    "prefill_slices": ("paged_prefill", {
        "as_built": {},
        "two_slices_d128": {"prefill_slices_d128": "2"},
    }),
    "paged_cluster": ("paged_attention", {
        "as_built": {},
        "tile_16_stages_4": {"paged_tile": "16", "paged_stages": "4"},
        "stages_3": {"paged_stages": "3"},
        "cluster_4": {"paged_cluster": "4"},
        "min_chunk_128": {"paged_min_chunk": "128"},
    }),
}

FLASH_SHAPES = [  # b, s, h, hkv, d, causal
    (12, 1024, 16, 16, 128, True),   # the training shape
    (1, 2048, 16, 16, 128, True),
    (2, 1024, 16, 16, 128, True),
    (4, 4096, 16, 16, 128, False),
    (1, 512, 32, 4, 64, True),
]
BWD_SHAPES = [  # b, s, h, hkv, d, causal
    (12, 1024, 16, 16, 128, True),   # the training shape
    (1, 2048, 16, 16, 128, True),
    (1, 512, 16, 16, 64, True),
    (1, 512, 32, 4, 64, True),
]
# the f32 backward's shapes: the DiT cell's attention, the training
# shape, GQA d 64 (b, s, h, hkv, d, causal)
BWD_TF32_SHAPES = [
    (32, 256, 8, 8, 64, False),
    (12, 1024, 16, 16, 128, True),
    (1, 512, 32, 4, 64, True),
]
# name, tokens routed top-2 over 8 experts (n = 2 tokens; 0: the JAX
# sweep's 32 rows over 4 experts), k, m, kernels
GMM_SHAPES = [
    ("up", 8192, 1024, 2816, ["wgmma"]),
    ("down", 8192, 2816, 1024, ["wgmma"]),
]
# the same with int8 rhs (the int8 wgmma kernel)
GMM_INT8_SHAPES = [(*c, True) for c in GMM_SHAPES]
# n k m from 38K multiply-adds to the up projection's 47G (the weight
# gradient's two designs cross between 134M and 5.9G)
GMM_CROSSOVER = [(name, t, k, m, ["mma", "wgmma"]) for name, t, k, m in (
    ("sweep_k24_m40", 0, 24, 40),              # 38K
    ("t64_k64_m128", 64, 64, 128),             # 1.0M
    ("t128_k128_m128", 128, 128, 128),         # 4.2M
    ("t256_k136_m200", 256, 136, 200),         # 13.9M
    ("t256_k128_m256", 256, 128, 256),         # 16.8M
    ("t256_k256_m256", 256, 256, 256),         # 33.6M
    ("t256_k384_m256", 256, 384, 256),         # 50.3M
    ("t256_k512_m256", 256, 512, 256),         # 67.1M
    ("t256_k1024_m256", 256, 1024, 256),       # 134M
    ("t512_k1024_m512", 512, 1024, 512),       # 537M
    ("t1024_k1024_m1024", 1024, 1024, 1024),   # 2.1G
    ("t512_k1024_m2816", 512, 1024, 2816),     # 2.95G
    ("t1024_k1024_m2816", 1024, 1024, 2816),   # 5.9G
    ("up", 8192, 1024, 2816),                  # 47G
)]
# the weight gradient over the same shapes
WGRAD_CROSSOVER = list(GMM_CROSSOVER)
# the transposed instance (rhs [e, m, k] read as rhs[g]^T), and int8 rhs
# at the widths its wgmma kernel takes (m % 16 == 0)
GMM_CROSSOVER += [(f"{name}_t", t, k, m, v, "trans")
                  for name, t, k, m, v in WGRAD_CROSSOVER]
GMM_CROSSOVER += [(f"{name}_int8", t, k, m, v, True)
                  for name, t, k, m, v in WGRAD_CROSSOVER if m % 16 == 0]
# the continuation kernel's split design: name, hq, hkv, d, cache_len,
# chunk tokens, int8 pool; the serving pool's geometry (page 16, 32
# pages a table), bf16 q
PREFILL_SHAPES = [
    ("serving_192_128", 16, 16, 128, 192, 128, False),
    ("serving_0_128", 16, 16, 128, 0, 128, False),
    ("serving_37_61", 16, 16, 128, 37, 61, False),
    ("serving_496_16", 16, 16, 128, 496, 16, False),
    ("int8_192_128", 16, 16, 128, 192, 128, True),
]
# the split design's geometry forced (prefill_split): the chunk shapes and
# the serving cell's verify windows (chip_smoke's VERIFY_*): name, hq,
# hkv, d, cache_len (None: the verify window), chunk tokens, int8 pool
PREFILL_SPLIT_SHAPES = PREFILL_SHAPES + [
    ("gqa_192_128", 32, 4, 64, 192, 128, False),
    ("verify_serving", 16, 16, 128, None, 5, False),
    ("verify_gqa", 32, 4, 64, None, 5, False),
    ("verify_int8", 16, 16, 128, None, 5, True),
]
# (splits, ring stages) forced in a build whose clusters go to 8 blocks
PREFILL_SPLIT_GEOMETRIES = [(1, 3), (1, 6), (2, 3), (4, 3), (8, 3)]
# name, q dtype, hq, hkv, d, lengths, page, pages per sequence, int8 pool
PAGED_LENGTHS = [0, 1, 15, 16, 17, 200, 511, 512]
PAGED_SHAPES = [
    ("serving", "bfloat16", 16, 16, 128, PAGED_LENGTHS, 16, 32, False),
    ("serving_int8", "bfloat16", 16, 16, 128, PAGED_LENGTHS, 16, 32, True),
    ("serving_f32", "float32", 16, 16, 128, PAGED_LENGTHS, 16, 32, False),
    ("gqa", "bfloat16", 32, 4, 64, PAGED_LENGTHS, 16, 32, False),
    ("long", "bfloat16", 16, 16, 128, [2048, 1000, 129, 3], 16, 128, False),
]


def marker_re(key):
    """The one line that ``key`` marks: (declaration =) (value) (; //
    sweep: key ...)."""
    return re.compile(r"^([^\n]*?=\s*)([^;\n]+?)(\s*;\s*//\s*sweep:\s*"
                      + re.escape(key) + r"\b[^\n]*)$", re.M)


def apply_variant(text, values):
    """``text`` with each marked value set; raises if a key does not mark
    exactly one line."""
    for key, value in values.items():
        pattern = marker_re(key)
        found = len(pattern.findall(text))
        if found != 1:
            raise ValueError(f"sweep marker {key!r} is on {found} lines, "
                             f"not one")
        text = pattern.sub(lambda mt: mt.group(1) + value + mt.group(3),
                           text)
    return text


def variant_dir(sweep, variant, values, source=None):
    """An edited copy of csrc for one variant (``values`` set in
    ``source``, by default the sweep's), under build/sweeps (its library,
    named by the sources' hash, is reused by the next turn)."""
    root = os.path.join(REPO, "build", "sweeps", f"{sweep}-{variant}")
    csrc = os.path.join(root, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(CSRC, csrc)
    if values:
        src = os.path.join(csrc, f"{source or SWEEPS[sweep][0]}.cu")
        with open(src) as f:
            text = apply_variant(f.read(), values)
        with open(src, "w") as f:
            f.write(text)
    return csrc, os.path.join(root, "lib")


def child(kind, csrc, build, shapes):
    """One variant's times, in a process of its own: {case: [mean ms,
    median ms]}."""
    from pathlib import Path

    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    _build.CSRC_DIR = Path(csrc)
    _build.BUILD_DIR = Path(build)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    if kind == "flash_attention":
        from paddle_tpu_torch.kernels import flash_attention as fa

        for b, s, h, hkv, d, causal in shapes:
            g = torch.Generator(device="cuda").manual_seed(s)
            q, k, v = (torch.randn(b, s, heads, d, generator=g,
                                   device="cuda").bfloat16()
                       for heads in (h, hkv, hkv))
            o, lse = fa._launch_fwd(q, k, v, causal, d ** -0.5, "wgmma")
            ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=causal)
            ok, _ = cs.compare(o, ref)
            assert ok and (lse - ref_lse).abs().max().item() <= 1e-3, "gate"
            del ref, ref_lse
            name = f"b{b}_s{s}_h{h}x{hkv}_d{d}" + ("" if causal else "_full")
            out[name] = cs.cuda_times(torch, lambda: fa._launch_fwd(
                q, k, v, causal, d ** -0.5, "wgmma"), 20, flush)
        return out
    if kind == "flash_attention_bwd":
        from paddle_tpu_torch.kernels import flash_attention as fa

        for b, s, h, hkv, d, causal in shapes:
            g = torch.Generator(device="cuda").manual_seed(s)
            q, k, v, do = (torch.randn(b, s, heads, d, generator=g,
                                       device="cuda").bfloat16()
                           for heads in (h, hkv, hkv, h))
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                              causal=causal)
            got = fa._bwd(q, k, v, o, lse, do, causal, d ** -0.5, "wgmma")
            assert all(cs.compare(x, r)[0] for x, r in zip(got, refs)), \
                "gate"
            del refs, got
            name = f"b{b}_s{s}_h{h}x{hkv}_d{d}" + ("" if causal else "_full")
            out[name] = cs.cuda_times(torch, lambda: fa._bwd(
                q, k, v, o, lse, do, causal, d ** -0.5, "wgmma"), 20, flush)
        return out
    if kind == "flash_attention_bwd_tf32":
        from paddle_tpu_torch.kernels import flash_attention as fa

        for b, s, h, hkv, d, causal in shapes:
            g = torch.Generator(device="cuda").manual_seed(s)
            q, k, v, do = (torch.randn(b, s, heads, d, generator=g,
                                       device="cuda")
                           for heads in (h, hkv, hkv, h))
            scale = d ** -0.5
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                              causal=causal)
            got = fa._bwd(q, k, v, o, lse, do, causal, scale, "tf32x3")
            assert all(cs.compare(x, r)[0] for x, r in zip(got, refs)), \
                "gate"
            del refs, got
            delta = fa._delta(o, do, "tf32x3")
            name = f"b{b}_s{s}_h{h}x{hkv}_d{d}" + ("" if causal else "_full")
            out[name] = cs.cuda_times(torch, lambda: fa._bwd(
                q, k, v, o, lse, do, causal, scale, "tf32x3"), 20, flush)
            out[f"{name}/dq"] = cs.cuda_times(torch, lambda: fa._launch_bwd_dq(
                q, k, v, do, o, lse, delta, causal, scale, "tf32x3"), 20,
                flush)
            out[f"{name}/dkv"] = cs.cuda_times(
                torch, lambda: fa._launch_bwd_dkv(
                    q, k, v, do, lse, delta, causal, scale, "tf32x3"), 20,
                flush)
        return out
    if kind == "paged_attention":
        from paddle_tpu_torch.kernels import paged_attention as pa

        for name, dt, hq, hkv, d, lengths, page, pps, quant in shapes:
            dtype = getattr(torch, dt)
            g = torch.Generator(device="cuda").manual_seed(1)
            b, n_pages = len(lengths), len(lengths) * pps
            q = torch.randn(b, hq, d, generator=g, device="cuda").to(dtype)
            kp, vp = (torch.randn(hkv, n_pages, page, d, generator=g,
                                  device="cuda").to(dtype) for _ in "kv")
            tables = torch.randperm(n_pages, generator=g, device="cuda")
            tables = tables.reshape(b, pps).to(torch.int32)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            k, v = ((pa.quantize_tokens(kp), pa.quantize_tokens(vp))
                    if quant else (kp, vp))
            (kq, ks), (vq, vs) = pa.split_pages(k), pa.split_pages(v)

            def run():
                return pa._launch(q, kq, vq, ks, vs, tables, lens,
                                  d ** -0.5, "cluster")

            try:
                got = run()
                torch.cuda.synchronize()
            except RuntimeError as err:   # a cluster the card refuses
                out[name] = str(err)[:200]
                continue
            ok, _ = cs.compare(got, pa.paged_attention_ref(q, k, v, tables,
                                                           lens))
            assert ok, "gate"
            out[name] = cs.cuda_times(torch, run, 50, flush)
        return out
    if kind in ("paged_prefill", "paged_prefill_split"):
        from paddle_tpu_torch.kernels import paged_prefill as pp
        from paddle_tpu_torch.kernels.paged_attention import quantize_tokens

        lib = pp._kernel()
        for name, hq, hkv, d, cache_len, n, quant in shapes:
            g = torch.Generator(device="cuda").manual_seed(hq + n + d)
            if cache_len is None:   # the verify window: 8 slots of 5 rows
                slots, s = len(cs.VERIFY_POSITIONS), n
                cl = torch.tensor(cs.VERIFY_POSITIONS, dtype=torch.int32,
                                  device="cuda")
                ln = torch.tensor([(x + 1) * a for x, a in zip(
                    cs.VERIFY_DRAFTS, cs.VERIFY_ACTIVE)], dtype=torch.int32,
                    device="cuda")
            else:
                slots, s = 1, max(16, 1 << (n - 1).bit_length())  # bucket
                cl = torch.tensor([cache_len], dtype=torch.int32,
                                  device="cuda")
                ln = torch.tensor([n], dtype=torch.int32, device="cuda")
            q = torch.randn(slots, s, hq, d, generator=g,
                            device="cuda").bfloat16()
            kp, vp = (torch.randn(hkv, 257, 16, d, generator=g,
                                  device="cuda").bfloat16() for _ in "kv")
            table = torch.stack([torch.randperm(256, generator=g,
                                                device="cuda")[:32]
                                 for _ in range(slots)]).to(torch.int32)
            k, v = ((quantize_tokens(kp), quantize_tokens(vp)) if quant
                    else (kp, vp))
            (kq, ks), (vq, vs) = pp.split_pages(k), pp.split_pages(v)
            ref = pp.paged_prefill_ref(q, k, v, table, cl, ln)
            rows = torch.arange(s, device="cuda")[None] < ln[:, None]

            def forced(splits, stages):
                # the split kernel at a geometry of our own
                o = torch.empty_like(q)
                err = lib.paged_prefill_launch(
                    q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                    ks.data_ptr() if quant else None,
                    vs.data_ptr() if quant else None, table.data_ptr(),
                    cl.data_ptr(), ln.data_ptr(), o.data_ptr(), slots, s,
                    hq, hkv, 257, 16, 32, d, d ** -0.5, 1, int(quant), 1,
                    pp.split_rows(s, hq // hkv), splits, stages,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, f"launch failed: CUDA error {err}"
                return o

            runs = {"wrapper": lambda: pp._launch(
                q, kq, vq, ks, vs, table, cl, ln, d ** -0.5)}
            if kind == "paged_prefill_split":
                runs["ring"] = lambda: pp._launch(
                    q, kq, vq, ks, vs, table, cl, ln, d ** -0.5, "ring")
                for sp, st in PREFILL_SPLIT_GEOMETRIES:
                    runs[f"s{sp}_st{st}"] = \
                        lambda sp=sp, st=st: forced(sp, st)
            for key, run in runs.items():
                ok, _ = cs.compare(run()[rows], ref[rows])
                assert ok, f"gate {name} {key}"
                label = name if key == "wrapper" else f"{name}/{key}"
                out[label] = cs.cuda_times(torch, run, 20, flush)
        return out
    from paddle_tpu_torch.kernels import grouped_matmul as gk
    from paddle_tpu_torch.quantization import weight_quantize_grouped

    for name, tokens, k, m, variants, *opt in shapes:
        sizes = (cs._routed_group_sizes(torch, tokens, 1024, 8, 2, seed=3)
                 if tokens else cs.GMM_SWEEP[0])
        gs = torch.as_tensor(sizes, dtype=torch.int32, device="cuda")
        n, e = int(gs.sum()), gs.numel()
        g = torch.Generator(device="cuda").manual_seed(n + k + m)
        lhs = torch.randn(n, k, generator=g, device="cuda").bfloat16()
        if kind == "grouped_matmul_bwd":   # the weight gradient
            dout = torch.randn(n, m, generator=g, device="cuda").bfloat16()
            ref = gk._segment_outer(lhs, dout, gs, e)

            def run(v):
                return gk._launch_wgrad(lhs, dout, gs, e, variant=v)
        else:
            trans = bool(opt) and opt[0] == "trans"
            rhs = (torch.randn(e, m, k, generator=g, device="cuda")
                   if trans else
                   torch.randn(e, k, m, generator=g, device="cuda"))
            rhs = (rhs / k ** 0.5).bfloat16()
            scales = None
            if opt and opt[0] is True:
                rhs, scales = weight_quantize_grouped(rhs.float())
            ref = gk.grouped_matmul_ref(
                lhs, rhs.transpose(1, 2) if trans else rhs, gs, scales)

            def run(v):
                return gk._launch(lhs, rhs, gs, scales, variant=v,
                                  trans_rhs=trans)
        for v in variants:
            ok, _ = cs.compare(run(v), ref)
            assert ok, "gate"
            out[f"{name}/{v}"] = cs.cuda_times(torch, lambda: run(v), 20,
                                               flush)
    return out


def run_child(kind, csrc, build, shapes):
    spec = json.dumps({"kind": kind, "csrc": csrc, "build": build,
                       "shapes": shapes})
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        spec], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SystemExit(f"chip_sweeps: {kind} variant failed:\n"
                         f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweeps", default=",".join(
        [*SWEEPS, "gmm_crossover", "wgrad_crossover", "prefill_split"]))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        spec = json.loads(args.child)
        print(json.dumps(child(spec["kind"], spec["csrc"], spec["build"],
                               spec["shapes"])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_sweeps: no CUDA device; nothing run", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"device": card}
    for sweep in args.sweeps.split(","):
        report[sweep] = {}
        if sweep == "prefill_split":
            # one build with clusters up to 8 blocks, geometries forced,
            # in two turns
            csrc, build = variant_dir(sweep, "max_8",
                                      {"prefill_max_splits": "8"},
                                      "paged_prefill")
            for turn in range(2):
                times = run_child("paged_prefill_split", csrc, build,
                                  PREFILL_SPLIT_SHAPES)
                report[sweep][f"turn{turn}"] = times
                print(f"[{sweep}] (turn {turn}) {json.dumps(times)}",
                      flush=True)
            continue
        if sweep in ("gmm_crossover", "wgrad_crossover"):
            # two turns, the kernels' order swapped in the second
            kind, cases = {
                "gmm_crossover": ("grouped_matmul", GMM_CROSSOVER),
                "wgrad_crossover": ("grouped_matmul_bwd", WGRAD_CROSSOVER),
            }[sweep]
            csrc, build = variant_dir(sweep, "as_built", {})
            for turn in range(2):
                shapes = [(*c[:4], c[4][::-1] if turn else c[4], *c[5:])
                          for c in cases]
                times = run_child(kind, csrc, build, shapes)
                report[sweep][f"turn{turn}"] = times
                print(f"[{sweep}] (turn {turn}) {json.dumps(times)}",
                      flush=True)
            continue
        kind, variants = SWEEPS[sweep]
        shapes = {"flash_attention": FLASH_SHAPES,
                  "flash_attention_bwd": BWD_SHAPES,
                  "paged_attention": PAGED_SHAPES,
                  "paged_prefill": PREFILL_SHAPES}.get(kind, GMM_SHAPES)
        if sweep == "gmm_int8_stages":
            shapes = GMM_INT8_SHAPES
        if sweep == "flash_stages":
            shapes = [x for x in shapes if x[4] == 128]
        if sweep == "flash_bwd_tf32":
            kind, shapes = "flash_attention_bwd_tf32", BWD_TF32_SHAPES
        for turn in range(2):
            for variant, values in variants.items():
                csrc, build = variant_dir(sweep, variant, values)
                times = run_child(kind, csrc, build, shapes)
                report[sweep][f"{variant}#{turn}"] = times
                print(f"[{sweep}] {variant} (turn {turn}) "
                      f"{json.dumps(times)}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
