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
* ``gmm_tile``: the grouped GEMM's output tile 128 x 256
  (wgmma.m64n256k16) against 128 x 128;
* ``gmm_epilogue``: the grouped GEMM's output through a TMA store from
  shared memory against bf16 pairs stored straight from the registers;
* ``gmm_crossover``: the wgmma and the mma.sync grouped GEMM side by side
  from the JAX sweep shape to the MoE layer's (the built sources as they
  are), for ``grouped_matmul.WGMMA_MIN_MACS``, in two turns with the
  kernels' order swapped.

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
    "gmm_tile": ("grouped_matmul", {
        "n256": {},
        "n128": {"gmm_tile_n": "128"},
    }),
    "gmm_epilogue": ("grouped_matmul", {
        "tma_store": {},
        "register_store": {"gmm_tma_store": "false"},
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
# name, tokens routed top-2 over 8 experts (n = 2 tokens; 0: the JAX
# sweep's 32 rows over 4 experts), k, m, kernels
GMM_SHAPES = [
    ("up", 8192, 1024, 2816, ["wgmma"]),
    ("down", 8192, 2816, 1024, ["wgmma"]),
]
# n k m from 38K multiply-adds to the up projection's 47G
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
    ("t1024_k1024_m2816", 1024, 1024, 2816),   # 5.9G
    ("up", 8192, 1024, 2816),                  # 47G
)]


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


def variant_dir(sweep, variant, values):
    """An edited copy of csrc for one variant, under build/sweeps (its
    library, named by the sources' hash, is reused by the next turn)."""
    root = os.path.join(REPO, "build", "sweeps", f"{sweep}-{variant}")
    csrc = os.path.join(root, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(CSRC, csrc)
    if values:
        src = os.path.join(csrc, f"{SWEEPS[sweep][0]}.cu")
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
    from paddle_tpu_torch.kernels import grouped_matmul as gk

    for name, tokens, k, m, variants in shapes:
        sizes = (cs._routed_group_sizes(torch, tokens, 1024, 8, 2, seed=3)
                 if tokens else cs.GMM_SWEEP[0])
        gs = torch.as_tensor(sizes, dtype=torch.int32, device="cuda")
        n, e = int(gs.sum()), gs.numel()
        g = torch.Generator(device="cuda").manual_seed(n + k + m)
        lhs = torch.randn(n, k, generator=g, device="cuda").bfloat16()
        rhs = (torch.randn(e, k, m, generator=g, device="cuda")
               / k ** 0.5).bfloat16()
        ref = gk.grouped_matmul_ref(lhs, rhs, gs)
        for v in variants:
            ok, _ = cs.compare(gk._launch(lhs, rhs, gs, None, variant=v), ref)
            assert ok, "gate"
            out[f"{name}/{v}"] = cs.cuda_times(torch, lambda: gk._launch(
                lhs, rhs, gs, None, variant=v), 20, flush)
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
    ap.add_argument("--sweeps", default=",".join([*SWEEPS, "gmm_crossover"]))
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
        if sweep == "gmm_crossover":
            # two turns, the kernels' order swapped in the second
            csrc, build = variant_dir(sweep, "as_built", {})
            for turn in range(2):
                shapes = [(*c[:4], c[4][::-1] if turn else c[4])
                          for c in GMM_CROSSOVER]
                times = run_child("grouped_matmul", csrc, build, shapes)
                report[sweep][f"turn{turn}"] = times
                print(f"[{sweep}] (turn {turn}) {json.dumps(times)}",
                      flush=True)
            continue
        kind, variants = SWEEPS[sweep]
        shapes = {"flash_attention": FLASH_SHAPES,
                  "flash_attention_bwd": BWD_SHAPES}.get(kind, GMM_SHAPES)
        if sweep == "flash_stages":
            shapes = [x for x in shapes if x[4] == 128]
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
