#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:

1. device   — the card's name and power limit (nvidia-smi). TF32 is
               switched off for matmuls and cuDNN, so the f32 phases run
               in full f32.
2. build    — compile every CUDA kernel of the port from
               ``paddle_tpu_torch/kernels/csrc`` for sm_90a (one nvcc per
               source, started together) and print ptxas's resource report.
3. kernels  — each kernel against its plain PyTorch version on the card,
               in the working dtype, at the serving and training shapes
               and the ones listed below; kernel, plain and library times
               from CUDA events, and the bound for the same work. Where a
               wrapper chooses among device kernels (the flash forward
               and backward: wgmma or mma.sync; the grouped GEMM, float
               and int8 rhs: wgmma or mma.sync; paged decode: the
               one-launch cluster kernel or the split-K kernel), every
               one that takes the inputs is held to the gate and timed
               side by side through the same host path (mean and median
               of 20 launches each, 50 for paged decode); ``ms`` is the
               wrapper's own call (a mean, as every ``ms``), ``prev_ms``
               the kernel that served these shapes before (mma.sync or
               FMA before the wgmma kernels, split-K before the cluster
               kernel). The gate (``GATE``) must also reject two planted
               faults of the backward at the training shape (a wrong
               ``out``, from which the wgmma dq kernel computes delta).
               The int8 paged kernel also stays within 0.05 of the float
               kernel on the unquantized pages; the grouped GEMM runs at
               the MoE layer's shapes, the JAX sweeps of empty and
               one-row groups, f32 and int8 rhs. float16: paged decode
               over float16 and int8 pools, the grouped GEMM with
               float16 lhs and float16 or int8 rhs. The fused KV write
               (``kv_write``) at the serving decode shape (8 rows) and a
               512-row prefill, bf16, float16, f32 and int8 pools:
               pages and scales equal to its plain version bit for bit.
4. parity   — tiny f32 Llama (MHA and GQA), the engine's programs
               captured as CUDA graphs: greedy outputs token-identical to
               the port's ``generate``, with ``decode_kernel`` "auto" and
               "xla" (the plain paged attention, counted); one decode
               program; a seeded sampled request's first token does not
               follow the engine's history.
5. serving  — full-width bf16 Llama (the repo's serving configuration,
               12 layers, random seeded weights) serving 32 mixed
               requests through ``Engine.generate``, every step a graph
               replay: all finish, no KV block leaks; counted from the
               replays, each decode step runs the paged kernel (cluster)
               once per layer, each prefill the flash kernel once per
               layer, every step the kv_write kernel once per layer; no
               kernel launched outside a graph, one replay per step; two
               decode programs (greedy and mixed), at most one prefill
               program per bucket. The warm-up engine's first decode
               step's logits (the replay's output) agree with the same
               step run eagerly with the plain attention function on
               copies of the pool, and its greedy tokens equal those of
               the same engine with its program functions run eagerly.
5b. serving_int8 — the same with ``EngineConfig(kv_cache_dtype="int8")``:
               every decode step runs the int8 paged kernel once per
               layer and the float one never; it also reports the first
               step's logit gap to the bf16 pool and the bytes per token.
               In both, every paged launch is the cluster kernel's.
5c. serving_f16 — the serving model in float16, 8 requests over the
               float16 and the int8 pool: all finish, the paged kernel
               (float16 q) runs once per layer per decode step, and the
               first decode logits are within 5e-2 of plain attention.
6. train_parity — tiny f32 Llama (MHA and GQA): 10 ``TrainStep`` steps
               of AdamW through the flash kernels give the losses of the
               same 10 steps with the plain attention functions.
7. train    — the repo's pretraining configuration (``bench.py``'s
               ``bench_llama``: 12 layers, hidden 2048, bf16 weights from a
               seed, fused chunked loss, AdamW with fp32 master weights),
               batch 12 x 1024 tokens: the first step's loss and every
               parameter's gradient against the same step with plain
               attention, then 14 ``TrainStep`` steps (1 + 3 warm-up + 10
               timed) with 12 forward, 12 dq and 12 dk/dv flash launches
               per step, all on the wgmma kernels (``attention_delta``
               never runs: the dq kernel computes delta), one profiled
               step, 2 steps with ``recompute`` and 1 step without the
               fused loss.
8. moe      — ``bench.py``'s MoE layer (``bench_kernels``: d_model 1024,
               8 experts, d_ff 2816, top-2, 8 x 1024 tokens, bf16):
               ``impl="ragged"`` runs 3 grouped GEMM launches and agrees
               with the plain grouped GEMM and with ``impl="dense"`` when
               nothing drops; its gradients agree with the plain version;
               ``quantize_moe_experts`` gives 3 int8 launches (on the
               int8 wgmma kernel, timed against the mma.sync one) within
               5 % of the float layer and refuses gradients; ragged and
               dense tokens/s; the same layer in float16, float and int8
               experts, 3 wgmma launches each, against the plain grouped
               GEMM; then one forward of ``bench_moe``'s level-0 Llama
               MoE (8 layers) against plain attention.

``--phases`` picks a subset; ``profile`` (a profiled decode step over the
bf16 and the int8 pool, replayed and with the program function run
eagerly) runs only when named.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. ``--out PATH`` also writes the full report (every case, the
serving, training and MoE counters) as JSON to PATH.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
# Kernel output vs its plain version on the same inputs, for each output
# tensor (out; dq, dk, dv), scaled to the data: with randn inputs at
# scale 1/sqrt(d) the outputs of late causal rows are an order of
# magnitude smaller than those of the first rows, so no fixed absolute
# bound fits both.
#  - relative L2 error ||out - ref|| / ||ref|| <= l2. bf16: both sides
#    round the output to bf16 (~2^-10 RMS relative), and the tensor-core
#    kernels also round P (and dS) to bf16 as mma operands, ~2^-10 RMS
#    per term with random signs; f32: summation order only.
#  - every element: |out - ref| <= atol + rtol * |ref| + row_ulps * ulp
#    * rowmax|ref| + floor * rms(ref), rowmax over the head dim of its own
#    row, ulp the type's unit roundoff (bf16 2^-8). bf16: two ulps of its
#    own (rtol 2^-7: both sides round to bf16), 4 of the row's largest
#    element (an element that cancels to near 0 keeps its row's rounding
#    error), and a floor of 2^-12 of the tensor's RMS for a row that
#    cancels whole (dq's first causal row is 0, its one key giving dP =
#    delta; the kernels leave ~3e-7 there); f32: the fixed bound, as the
#    L2 term is the tight one there.
#  - float16 is bf16's gate scaled by the ratio of the unit roundoffs,
#    2^-11 / 2^-8 = 2^-3: l2 1.25e-3, rtol 2^-10, 4 ulps (2^-11) of the
#    row's largest element, a floor of 2^-15 of the RMS; and, as float16
#    (unlike bf16) has a narrow exponent, 4 steps of its subnormal
#    spacing 2^-24 as atol: below 2^-14 its values keep that fixed
#    absolute spacing (the MoE layer's outputs, ~1e-5, lie there). Its
#    kernels (paged decode, grouped GEMM) keep f32 scores and accumulators
#    and round only the output, as the plain versions do.
# gate_faults() shows that a backward with delta left out, or 10 % off in
# the late rows only, fails this gate at the training shape.
GATE = {
    "bfloat16": {"l2": 1e-2, "rtol": 2.0 ** -7, "row_ulps": 4,
                 "ulp": 2.0 ** -8, "floor": 2.0 ** -12, "atol": 0.0},
    "float16": {"l2": 1.25e-3, "rtol": 2.0 ** -10, "row_ulps": 4,
                "ulp": 2.0 ** -11, "floor": 2.0 ** -15,
                "atol": 4 * 2.0 ** -24},
    "float32": {"l2": 1e-5, "rtol": 1e-4, "row_ulps": 0, "ulp": 0.0,
                "floor": 0.0, "atol": 1e-4},
}
# a fixed bound of the kind bf16 flash checks often use, reported beside
# each planted fault to show what it would let through
FIXED_BOUND = (3e-2, 2e-2)
# first decode step of the full-width bf16 model, paged kernel vs plain
# attention: both round the attention output to bf16, and the 1-ulp
# differences this leaves pass through 12 layers of bf16 matmuls
LOGITS_TOL = 5e-2
# first training step of the full-width bf16 model, flash kernels vs plain
# attention: the loss within 1e-2 (bf16 activations through 12 layers,
# the loss near ln(32000) ~ 10), and every parameter's gradient within a
# relative L2 error of 5e-2 (the kernels round P and dS to bf16; every
# gradient is a bf16 sum through up to 12 layers of bf16 matmuls)
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_RTOL = 5e-2
# tiny f32 training, kernels vs plain attention over 10 AdamW steps
PARITY_LOSS_RTOL = 1e-4
# int8 paged kernel against the float kernel on the unquantized pages:
# the JAX contract of test_int8_pool_tolerance (rtol, atol)
INT8_POOL_TOL = (0.05, 0.05)
# full-width ragged MoE layer (relative L2 error): against the dense impl
# with nothing dropped (bf16 expert products rounded at other places), its
# gradients against the plain grouped GEMM (bf16 sums through the
# backward), and int8 experts against the float layer (docs/kernels.md's
# ~5 % bound on a SwiGLU layer)
MOE_DENSE_L2 = 1e-2
MOE_GRAD_L2 = 5e-2
MOE_INT8_L2 = 5e-2
# bench.py's bench_kernels MoE layer and bench_moe level-0 model (bf16)
MOE_LAYER = dict(d_model=1024, num_experts=8, d_ff=2816, k=2)
MOE_BATCH, MOE_SEQ = 8, 1024
MOE_LLAMA_CFG = dict(
    vocab_size=32000, hidden_size=1024, intermediate_size=2816,
    num_hidden_layers=8, num_attention_heads=16,
    max_position_embeddings=2048, num_experts=8, num_experts_per_tok=2,
    fused_loss_chunk=2048, dtype="bfloat16",
)
# the JAX grouped-GEMM sweeps: empty leading, trailing and interior
# groups, single-row segments, all rows on one expert
GMM_SWEEP = [[5, 0, 11, 16], [0, 0, 32, 0], [1, 1, 1, 29], [32, 0, 0, 0],
             [0, 7, 1, 24]]
# bench.py's bench_llama configuration (its TPU branch), bf16 weights
TRAIN_CFG = dict(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=12, num_attention_heads=16,
    max_position_embeddings=2048, fused_loss_chunk=2048, dtype="bfloat16",
)
TRAIN_BATCH, TRAIN_SEQ = 12, 1024

REPO = os.path.dirname(os.path.abspath(__file__))


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_times(torch, fn, iters, flush):
    """(mean, median) device ms of ``fn`` over ``iters`` launches, each
    timed with CUDA events after a write of ``flush`` (bigger than the 50
    MB L2, so every launch starts from a cold cache and the host's launch
    overhead hides behind the flush). The mean is every kernel's ``ms``;
    the median, reported beside it where a wrapper has several kernels,
    is less moved by a launch the shared host delays past the flush."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times)), float(np.median(times))


def cuda_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` (``cuda_times``)."""
    return cuda_times(torch, fn, iters, flush)[0]


# --------------------------------------------------------------- kernels
def compare(out, ref):
    """(within ``GATE``, what the gate read) for a kernel output against
    its plain version. ``limit_frac`` is the largest element's error as a
    fraction of its bound; ``ref_rms`` and ``ref_absmax`` give the scale."""
    gate = GATE[str(out.dtype).split(".")[-1]]
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    rms = r.square().mean().sqrt()
    bound_ = (gate["atol"] + gate["rtol"] * r.abs() + gate["floor"] * rms
              + gate["row_ulps"] * gate["ulp"]
              * r.abs().amax(dim=-1, keepdim=True))
    stats = {
        "max_abs_err": diff.max().item(),
        "rel_l2": (diff.norm() / r.norm().clamp_min(1e-30)).item(),
        "limit_frac": (diff / bound_.clamp_min(1e-30)).max().item(),
        "ref_rms": rms.item(),
        "ref_absmax": r.abs().max().item(),
        "fixed_bound_ok": bool(
            (diff <= FIXED_BOUND[0] + FIXED_BOUND[1] * r.abs()).all()),
    }
    ok = (bool(o.isfinite().all()) and bool((diff <= bound_).all())
          and stats["rel_l2"] <= gate["l2"])
    return ok, stats


def bound(nbytes, flops, dtype, torch):
    """(bound ms, bound_by) for moving ``nbytes`` and doing ``flops``
    (16-bit types at the tensor cores' bf16/f16 rate)."""
    peak = (BF16_FLOPS if dtype in (torch.bfloat16, torch.float16)
            else F32_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


PAGED_VARIANTS = ("cluster", "split")


def paged_case(torch, pa, flush, name, dtype, hq, hkv, d, lengths,
               page=16, pages_per_seq=32, quant=False):
    """The paged kernels against ``paged_attention_ref`` on the same pages.
    ``ms`` is the wrapper's call (on the kernel ``_paged_variant`` picks);
    both device kernels (the cluster kernel and the split-K kernel,
    ``prev_ms``) are held to the gate and to exact zeros at length 0 and
    timed side by side through the wrapper (``variants``), the cluster
    kernel also alone (``_launch``: ``kernel_ms``, ``kernel_median_ms``).
    ``quant``: the int8 kernels on pages built by ``quantize_tokens``,
    also held to the float kernel on the unquantized pages
    (``INT8_POOL_TOL``)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    b = len(lengths)
    n_pages = b * pages_per_seq
    q = torch.randn(b, hq, d, generator=g, device=dev).to(dtype)
    kp = torch.randn(hkv, n_pages, page, d, generator=g,
                     device=dev).to(dtype)
    vp = torch.randn(hkv, n_pages, page, d, generator=g,
                     device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=g, device=dev)
    tables = perm.reshape(b, pages_per_seq).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    k, v = ((pa.quantize_tokens(kp), pa.quantize_tokens(vp)) if quant
            else (kp, vp))
    variant = pa._paged_variant(dtype, torch.int8 if quant else dtype)
    out = pa.paged_attention(q, k, v, tables, lens)
    ref = pa.paged_attention_ref(q, k, v, tables, lens)
    torch.cuda.synchronize()
    ok, stats = compare(out, ref)

    def zeros_exact(got):
        return all(bool((got[i] == 0).all())
                   for i, n in enumerate(lengths) if n == 0)

    zero_ok = zeros_exact(out)
    extra = {}
    if quant:
        flt = pa.paged_attention(q, kp, vp, tables, lens)
        rtol, atol = INT8_POOL_TOL
        gap = (out.float() - flt.float()).abs()
        ok = ok and bool((gap <= atol + rtol * flt.float().abs()).all())
        extra = {"float_pool_max_abs_gap": gap.max().item(),
                 "float_kernel_ms": cuda_ms(torch, lambda: pa.paged_attention(
                     q, kp, vp, tables, lens), 50, flush)}
    check(ok and zero_ok,
          f"paged_attention {name} (int8 {quant}, {variant}): {stats} "
          f"{extra} outside the gate or length-0 rows not exact zeros")

    def held(vname, got):
        ok_v, st = compare(got, ref)
        check(ok_v and zeros_exact(got),
              f"paged_attention {name} (int8 {quant}, {vname}): {st} "
              f"outside the gate or length-0 rows not exact zeros")
        return st

    ms = cuda_ms(torch, lambda: pa.paged_attention(q, k, v, tables, lens),
                 50, flush)
    variants = _timed_variants(
        torch, held, PAGED_VARIANTS,
        lambda vn: pa.paged_attention(q, k, v, tables, lens, variant=vn),
        flush, 50)
    # the cluster kernel alone: the inputs as the wrapper hands them over
    kq, ks = pa.split_pages(k)
    vq, vs = pa.split_pages(v)
    scale = 1.0 / d ** 0.5
    kernel_ms, kernel_median_ms = cuda_times(
        torch, lambda: pa._launch(q, kq, vq, ks, vs, tables, lens, scale,
                                  variant), 50, flush)
    plain_ms = cuda_ms(
        torch, lambda: pa.paged_attention_ref(q, k, v, tables, lens), 10,
        flush)
    tokens = sum(lengths)
    # q in, out; each cached K/V row once (int8: 1 byte an element and a
    # 4-byte scale a row); the tables
    row_bytes = d + 4 if quant else d * q.element_size()
    nbytes = (2 * q.numel() * q.element_size() + 2 * tokens * hkv * row_bytes
              + tables.numel() * 4 + b * 4)
    flops = 4 * tokens * hq * d
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    return {
        "case": name, "dtype": str(dtype).split(".")[-1], "int8": quant,
        "batch": b, "hq": hq, "hkv": hkv, "d": d, "page_size": page,
        "pages_per_seq": pages_per_seq, "lengths": list(lengths),
        "variant": variant, "prev": "split",
        **stats, **extra, "ms": ms, "prev_ms": variants["split"]["ms"],
        "kernel_ms": kernel_ms, "kernel_median_ms": kernel_median_ms,
        "variants": variants,
        "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }


def _routed_group_sizes(torch, n_tokens, d, e, k, seed):
    """Group sizes of ``n_tokens`` random bf16 tokens routed top-k over
    ``e`` experts by a random gate (the ragged dispatch's own count)."""
    from paddle_tpu_torch.ops import moe_ragged_dispatch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n_tokens, d, generator=g, device="cuda")
    w = torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
    return moe_ragged_dispatch(x, x @ w, k=k)[1]


def _timed_variants(torch, compare_to, variants, run, flush, iters):
    """Each device kernel in ``variants`` on the same inputs, through the
    same host path ``run(variant)``: its output held to
    ``compare_to(variant, out)`` (which checks and returns the gate's
    stats), then its times. Returns {variant: {stats..., "ms": mean,
    "median_ms": median}}."""
    result = {}
    for v in variants:
        out = run(v)
        torch.cuda.synchronize()
        stats = compare_to(v, out)
        mean, median = cuda_times(torch, lambda: run(v), iters, flush)
        result[v] = dict(stats, ms=mean, median_ms=median)
    return result


def gmm_case(torch, gk, flush, name, dtype, k, m, group_sizes, quant=False):
    """The grouped GEMM kernels against ``grouped_matmul_ref`` on the same
    inputs (``GATE``); ``quant`` gives them int8 rhs with per-channel
    scales. ``ms`` is the wrapper's call (``grouped_matmul``, on the
    kernel ``_gmm_variant`` picks). Every device kernel that can take the
    inputs (bf16 lhs and rhs: the wgmma kernel and the mma.sync kernel)
    is held to the gate and timed side by side through ``_launch``
    (``variants``); ``prev_ms`` is the kernel the dtypes had before the
    wgmma kernel. Also times the plain version and, for bf16
    float rhs, ``torch._grouped_mm`` (never called by the port) where
    this PyTorch has it."""
    dev = "cuda"
    gs = torch.as_tensor(group_sizes, dtype=torch.int32, device=dev)
    n, e = int(gs.sum()), gs.numel()
    g = torch.Generator(device=dev).manual_seed(n + k + m)
    lhs = torch.randn(n, k, generator=g, device=dev).to(dtype)
    rhs = (torch.randn(e, k, m, generator=g, device=dev)
           / k ** 0.5).to(dtype)
    scales = None
    if quant:
        from paddle_tpu_torch.quantization import weight_quantize_grouped

        rhs, scales = weight_quantize_grouped(rhs.float())
    variant = gk._gmm_variant(lhs.dtype, rhs.dtype, n, k, m, e)
    prev = "fma" if dtype == torch.float32 else "mma"
    # the wgmma kernels take 16-bit lhs with k > 0 (int8 rhs: m % 16 == 0)
    wgmma_ok = (dtype != torch.float32 and k > 0
                and (not quant or m % 16 == 0))
    kinds = ([variant, prev] if variant != prev else [variant]) + (
        ["wgmma"] if variant != "wgmma" and wgmma_ok else [])
    with torch.no_grad():
        out = gk.grouped_matmul(lhs, rhs, gs, scales)
        ref = gk.grouped_matmul_ref(lhs, rhs, gs, scales)
        torch.cuda.synchronize()
        ok, stats = compare(out, ref)
        check(ok, f"grouped_matmul {name} ({variant}): {stats} outside the "
                  f"gate")

        def held(v, got):
            ok_v, st = compare(got, ref)
            check(ok_v, f"grouped_matmul {name} ({v}): {st} outside the "
                        f"gate")
            return st

        ms = cuda_ms(torch, lambda: gk.grouped_matmul(lhs, rhs, gs, scales),
                     20, flush)
        variants = _timed_variants(
            torch, held, kinds,
            lambda v: gk._launch(lhs, rhs, gs, scales, variant=v), flush, 20)
        plain_ms = cuda_ms(
            torch, lambda: gk.grouped_matmul_ref(lhs, rhs, gs, scales), 5,
            flush)
        library_ms, library_note = None, "none: int8 or f32 rhs"
        if not quant and dtype != torch.float32:
            library_note = "torch._grouped_mm absent"
            if hasattr(torch, "_grouped_mm"):
                offs = torch.cumsum(gs, 0, dtype=torch.int32)
                rhs_cm = rhs.transpose(1, 2).contiguous().transpose(1, 2)
                try:
                    lib = torch._grouped_mm(lhs, rhs_cm, offs=offs)
                    torch.cuda.synchronize()
                    lib_ok, lib_stats = compare(lib, ref)
                    library_ms = cuda_ms(torch, lambda: torch._grouped_mm(
                        lhs, rhs_cm, offs=offs), 20, flush)
                    library_note = ("torch._grouped_mm" if lib_ok else
                                    f"torch._grouped_mm, off the gate: "
                                    f"{lib_stats}")
                except (RuntimeError, TypeError) as err:
                    library_note = f"torch._grouped_mm refused: {err}"[:200]
    nbytes = (lhs.numel() * lhs.element_size()
              + rhs.numel() * rhs.element_size()
              + (scales.numel() * 4 if quant else 0)
              + out.numel() * out.element_size())
    flops = 2 * n * k * m
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    case = {
        "case": name, "dtype": str(dtype).split(".")[-1],
        "rhs": "int8" if quant else str(dtype).split(".")[-1], "n": n,
        "k": k, "m": m, "experts": e,
        "group_sizes": [int(x) for x in gs.tolist()], "variant": variant,
        "prev": prev, **stats, "ms": ms, "prev_ms": variants[prev]["ms"],
        "variants": variants,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": library_note, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }
    log(f"[kernels] gmm {json.dumps(case)}")
    return case


def flash_case(torch, fa, flush, s, dtype=None, h=16, d=128, b=1,
               offset=0, hkv=None, causal=True):
    """The forward kernels against ``flash_attention_ref``: out within
    ``GATE``, lse within 1e-3. ``offset`` > 0 starts q, k and v that many
    elements into their buffers, off the 16-byte grid the bf16 kernels
    load on; ``hkv`` < ``h`` is GQA. ``ms`` is the wrapper's call
    (``flash_attention_fwd``, its aligning copies included, on the kernel
    ``_fwd_variant`` picks). Every device kernel that takes the inputs
    (bf16 at d 64 or 128: the wgmma kernel and the mma.sync kernel) is
    held to both bounds and timed side by side through the wrapper's own
    steps (the copies, then ``_launch_fwd``: ``variants``), and with
    ``offset`` also alone on aligned copies (``kernel_ms``,
    ``kernel_median_ms``); ``prev_ms`` is the dtype's kernel before the
    wgmma one."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    hkv = hkv or h
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(s)

    def make(heads):
        n = b * s * heads * d
        return (torch.randn(n + offset, generator=g, device=dev)
                .to(dtype)[offset:].view(b, s, heads, d))

    q, k, v = make(h), make(hkv), make(hkv)
    scale = d ** -0.5
    name = f"s{s}" + (f"_b{b}" if b > 1 else "") + (
        f"_gqa{h}x{hkv}" if hkv != h else "") + (f"_d{d}" if d != 128
                                                 else "") + (
        "_full" if not causal else "") + ("_unaligned" if offset else "")
    variant = fa._fwd_variant(dtype, d, s, s)
    prev = "fma" if dtype == torch.float32 else "mma"
    kinds = [variant, prev] if variant != prev else [variant]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()

    def held(vname, got):
        o, l = got
        ok, st = compare(o, ref)
        lse_err = (l - ref_lse).abs().max().item()
        check(ok and lse_err <= 1e-3,
              f"flash_attention {name} ({vname}): {st} outside the gate or "
              f"lse err {lse_err} > 1e-3")
        return dict(st, lse_max_abs_err=lse_err)

    stats = held(variant, (out, lse))

    ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                       causal=causal),
                 20, flush)
    variants = _timed_variants(
        torch, held, kinds,
        lambda vn: fa._launch_fwd(*(fa._aligned(t) for t in (q, k, v)),
                                  causal, scale, vn), flush, 20)
    if offset:
        # the kernels alone, on aligned copies made once (aligned inputs
        # have no copies to leave out: there the times above are these)
        qa, ka, va = (fa._aligned(t) for t in (q, k, v))
        for vn in kinds:
            variants[vn]["kernel_ms"], variants[vn]["kernel_median_ms"] = \
                cuda_times(torch, lambda: fa._launch_fwd(qa, ka, va, causal,
                                                         scale, vn),
                           20, flush)
    plain_ms = cuda_ms(
        torch, lambda: fa.flash_attention_ref(q, k, v, causal=causal), 5,
        flush)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = {"enable_gqa": True} if hkv != h else {}
    library_ms = cuda_ms(
        torch,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               **gqa),
        20, flush)
    item = q.element_size()
    # q, k, v, out, lse
    nbytes = (2 * q.numel() + 2 * k.numel()) * item + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    return {
        "case": name, "dtype": str(dtype).split(".")[-1], "batch": b,
        "heads": h, "kv_heads": hkv, "d": d, "seq": s, "causal": causal,
        "variant": variant, **stats, "ms": ms,
        "prev_ms": variants[prev]["ms"], "variants": variants,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "flops": flops,
    }


def flash_bwd_case(torch, fa, flush, name, s, dtype=None, h=16, hkv=None,
                   d=128, b=1, causal=True, offset=0):
    """The backward kernels against ``flash_attention_bwd_ref`` on the
    forward kernel's out and lse; ``offset`` > 0 starts every input that
    many elements into its buffer (off the 16-byte grid). ``ms`` is the
    wrapper's call (``flash_attention_bwd``: its aligning copies, delta
    and both kernels of the design ``_bwd_variant`` picks), the mean of
    20, as every ``ms``; ``median_ms`` its median. Every design that takes
    the inputs (bf16 at d 64 or 128: the wgmma kernels and the mma.sync
    kernels) is held to the gate and timed side by side through the
    wrapper's own steps (``fa._bwd``: ``variants``), and each kernel alone
    on aligned inputs (``dq_ms``, ``dkv_ms`` and their medians: the wgmma
    dq kernel computes delta, the mma.sync one reads it); ``prev_ms`` is
    the dtype's design before the wgmma kernels."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    hkv = hkv or h
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1000 + s)

    def make(heads):
        n = b * s * heads * d
        return (torch.randn(n + offset, generator=g, device=dev)
                .to(dtype)[offset:].view(b, s, heads, d))

    q, k, v, do = make(h), make(hkv), make(hkv), make(h)
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    variant = fa._bwd_variant(dtype, d, s, s)
    prev = "fma" if dtype == torch.float32 else "mma"
    kinds = [variant, prev] if variant != prev else [variant]
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    refs = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()

    def held(vname, got):
        gate = {}
        for gname, x, ref in zip(("dq", "dk", "dv"), got, refs):
            ok, gate[gname] = compare(x, ref)
            check(ok, f"flash_attention_bwd {name} ({vname}): {gname} "
                      f"{gate[gname]} outside the gate")
        return {"gate": gate, "max_abs_err": {
            gn: st["max_abs_err"] for gn, st in gate.items()}}

    stats = held(variant, grads)
    ms, median_ms = cuda_times(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=causal), 20, flush)
    qa, ka, va, oa, da = (fa._aligned(t) for t in (q, k, v, out, do))
    variants = _timed_variants(
        torch, held, kinds,
        lambda vn: fa._bwd(qa, ka, va, oa, lse, da, causal, scale, vn),
        flush, 20)
    for vn in kinds:
        # each kernel alone; the dk/dv kernel on the delta of a dq launch
        delta = fa._delta(oa, da, vn)
        fa._launch_bwd_dq(qa, ka, va, da, oa, lse, delta, causal, scale, vn)
        t = variants[vn]
        t["dq_ms"], t["dq_median_ms"] = cuda_times(
            torch, lambda: fa._launch_bwd_dq(qa, ka, va, da, oa, lse, delta,
                                             causal, scale, vn), 20, flush)
        t["dkv_ms"], t["dkv_median_ms"] = cuda_times(
            torch, lambda: fa._launch_bwd_dkv(qa, ka, va, da, lse, delta,
                                              causal, scale, vn), 20, flush)
        t["kernel_median_ms"] = t["dq_median_ms"] + t["dkv_median_ms"]
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=causal), 5, flush)
    # yardstick: PyTorch's own attention backward (never called by the
    # port), on aligned copies: it faults on inputs off the 16-byte grid
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (qa, ka, va))
    gqa = {"enable_gqa": True} if hkv != h else {}
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)
    dot = da.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), 20, flush)
    item = q.element_size()
    nq, nkv = q.numel() * item, k.numel() * item
    rows = b * h * s * 4                       # one f32 per query row
    pairs = s * (s + 1) // 2 if causal else s * s
    prod = 2 * b * h * d * pairs               # one s x s x d product
    # the function: q, k, v, out, dO read, dq, dk, dv written, lse and
    # delta; five products. Each kernel alone: its own reads and writes;
    # dq runs S, dP, dS K (3), dk/dv S^T, dP^T, P^T dO, dS^T Q (4)
    b_ms, b_by = bound(3 * nq + 2 * nkv + 2 * nkv + nq + 2 * rows,
                       5 * prod, dtype, torch)
    dq_b, dq_by = bound(3 * nq + 2 * nkv + 2 * rows, 3 * prod, dtype, torch)
    dkv_b, dkv_by = bound(2 * nq + 4 * nkv + 2 * rows, 4 * prod, dtype,
                          torch)
    case = {
        "case": name, "dtype": str(dtype).split(".")[-1], "batch": b,
        "heads": h, "kv_heads": hkv, "d": d, "seq": s, "causal": causal,
        "offset": offset, "variant": variant, **stats,
        "ms": ms, "median_ms": median_ms,
        "dq_ms": variants[variant]["dq_ms"],
        "dkv_ms": variants[variant]["dkv_ms"],
        "prev_ms": variants[prev]["ms"], "variants": variants,
        "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "dq_bound_ms": dq_b, "dq_bound_by": dq_by, "dkv_bound_ms": dkv_b,
        "dkv_bound_by": dkv_by, "flops": 5 * prod,
    }
    log(f"[kernels] {json.dumps(case)}")
    return case


def gate_faults(torch, fa, s=TRAIN_SEQ, b=TRAIN_BATCH, h=16, d=128):
    """``GATE`` must reject a bf16 backward with a planted fault, at the
    training shape. The wrapper runs on a wrong ``out``, from which the
    dq kernel computes delta: "no_delta" on out = 0 (delta = 0, dS = P dP
    scale), "late_delta" on out x 0.9 in the second half of the rows only
    (delta 10 % off there), a fault that changes each late gradient by a
    few ulps of its own (``FIXED_BOUND`` lets its dk through). dq and dk
    must fail; dv, which does not read delta, and the correct run must
    pass. Returns what the gate read on each."""
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    refs = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    late = out.clone()
    late[:, s // 2:] *= 0.9
    changed = {"none": (), "no_delta": ("dq", "dk"),
               "late_delta": ("dq", "dk")}
    result = {}
    for fault, o in (("none", out), ("no_delta", torch.zeros_like(out)),
                     ("late_delta", late)):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        for gname, x, ref in zip(("dq", "dk", "dv"), got, refs):
            ok, stats = compare(x, ref)
            result[f"{fault}.{gname}"] = dict(stats, gate_ok=ok)
            check(ok != (gname in changed[fault]),
                  f"gate: {fault} {gname} {'passed' if ok else 'failed'} "
                  f"({stats})")
    log(f"[kernels] gate faults {json.dumps(result)}")
    return result


SERVING_GEOMETRY = dict(hkv=16, d=128, page=16, pages_per_seq=32,
                        num_blocks=256)


def kv_write_case(torch, kw, flush, name, dtype, n, prefill, quant):
    """The fused KV-write kernel against ``kv_write_ref`` on the same pool
    and rows, at the serving pool's geometry (16 kv heads, d 128, page
    16, 32 pages a table, 256 blocks and the sink): the live pages and
    scales equal bit for bit (the sink, which the plain version writes
    and the kernel does not, left out). Decode: ``n`` rows, one per slot,
    with one at capacity and one inactive; prefill: row 0, positions
    0..n-1, the last 12 past the prompt's length. Times the wrapper's
    call, the plain version and, for a float pool, the library call: two
    ``index_put_`` (K and V) over the rows to write, their indices
    precomputed."""
    dev = "cuda"
    geo = SERVING_GEOMETRY
    hkv, d, page, pps, nb = (geo["hkv"], geo["d"], geo["page"],
                             geo["pages_per_seq"], geo["num_blocks"])
    g = torch.Generator(device=dev).manual_seed(n + 7 * quant)
    shape = (hkv, nb + 1, page, d)

    def pool():
        if quant:
            return (torch.randint(-127, 128, shape, generator=g, device=dev,
                                  dtype=torch.int8),
                    torch.rand(shape[:3], generator=g, device=dev))
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    kp, vp = pool(), pool()
    kn = (torch.randn(n, hkv, d, generator=g, device=dev) * 3).to(dtype)
    vn = torch.randn(n, hkv, d, generator=g, device=dev).to(dtype)
    kn[0, 0] = 0                                 # an all-zero row
    if prefill:
        tables = torch.randperm(nb, generator=g, device=dev)[:pps]
        tables = tables.view(1, pps).to(torch.int32)
        rows = torch.zeros(n, dtype=torch.int32, device=dev)
        positions = torch.arange(n, dtype=torch.int32, device=dev)
        valid = positions < n - 12
    else:
        tables = torch.randperm(nb, generator=g, device=dev)[:n * pps]
        tables = tables.view(n, pps).to(torch.int32)
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        positions = torch.randint(0, pps * page, (n,), generator=g,
                                  device=dev, dtype=torch.int32)
        positions[1] = pps * page                # at capacity
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[2] = False                         # an inactive slot
    args = (kn, vn, tables, rows, positions, valid)
    copy = _pool_copy([kp, vp])
    kw.kv_write(kp, vp, *args)
    kw.kv_write_ref(*copy, *args)
    torch.cuda.synchronize()
    live = [t[:, :-1] for e in (kp, vp)
            for t in (e if quant else (e,))]
    want = [t[:, :-1] for e in copy for t in (e if quant else (e,))]
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(live, want))
    exact = all(torch.equal(a, b) for a, b in zip(live, want))
    check(exact, f"kv_write {name}: kernel and plain version differ (max "
                 f"abs {diff})")
    ms = cuda_ms(torch, lambda: kw.kv_write(kp, vp, *args), 50, flush)
    plain_ms = cuda_ms(torch, lambda: kw.kv_write_ref(*copy, *args), 20,
                       flush)
    write = valid & (positions < pps * page)
    w = int(write.sum())
    library_ms = None
    if not quant:
        pos = positions[write].long()
        phys = tables[rows[write].long(), pos // page].long()
        slot = pos % page
        ks, vs = kn[write].transpose(0, 1), vn[write].transpose(0, 1)

        def library():
            kp[:, phys, slot] = ks
            vp[:, phys, slot] = vs

        library_ms = cuda_ms(torch, library, 50, flush)
    elem = kn.element_size()
    page_elem = 1 if quant else elem
    # the rows it writes, read once and stored once (int8: their f32
    # scales too); rows, positions and valid read once, one table entry
    # per written row
    nbytes = (2 * w * hkv * d * (elem + page_elem) + (2 * w * hkv * 4
              if quant else 0) + n * 9 + w * 4)
    # int8: absmax, division and rounding per element, in f32
    flops = 3 * 2 * w * hkv * d if quant else 0
    bound_ms, bound_by = bound(nbytes, flops, torch.float32, torch)
    case = {"case": name, "dtype": str(dtype).split(".")[-1],
            "pool": "int8" if quant else str(dtype).split(".")[-1],
            "rows": n, "rows_written": w, "prefill": prefill, "hkv": hkv,
            "d": d, "page_size": page, "exact": exact, "max_abs_err": diff,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": ("index_put_ of K and V" if not quant else
                        "none: no PyTorch call quantizes and scatters"),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops}
    log(f"[kernels] kv_write {json.dumps(case)}")
    return case


def phase_kernels(torch):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import grouped_matmul as gk
    from paddle_tpu_torch.kernels import kv_write as kw
    from paddle_tpu_torch.kernels import paged_attention as pa

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lengths = [0, 1, 15, 16, 17, 200, 511, 512]   # 0, partial, full pages
    cases = [
        ("serving", torch.bfloat16, 16, 16, 128, lengths, {}),
        ("gqa", torch.bfloat16, 32, 4, 64, lengths, {}),
        ("serving_f32", torch.float32, 16, 16, 128, lengths, {}),
        # 16 chunks per sequence, most of them empty for the short ones
        ("long", torch.bfloat16, 16, 16, 128, [2048, 1000, 129, 3],
         {"pages_per_seq": 128}),
        # head dim and page size that take the scalar-load path
        ("odd", torch.bfloat16, 6, 2, 20, [37, 0, 5],
         {"page": 5, "pages_per_seq": 8}),
        ("serving_f16", torch.float16, 16, 16, 128, lengths, {}),
    ]
    paged = [paged_case(torch, pa, flush, *c[:6], **c[6]) for c in cases]
    quant = [paged_case(torch, pa, flush, *c[:6], **c[6], quant=True)
             for c in cases]
    flash = [flash_case(torch, fa, flush, s)
             for s in (16, 32, 64, 100, 128, 512, 2048)]
    flash += [
        flash_case(torch, fa, flush, 100, dtype=torch.float32),
        flash_case(torch, fa, flush, 100, offset=1),
        flash_case(torch, fa, flush, 512, h=32, hkv=4, d=64),   # GQA d 64
        flash_case(torch, fa, flush, 100, h=32, hkv=4, d=64),   # ragged
        flash_case(torch, fa, flush, 128, causal=False),
        flash_case(torch, fa, flush, 100, causal=False),
        flash_case(torch, fa, flush, 128, d=32),                # mma.sync
        flash_case(torch, fa, flush, TRAIN_SEQ, b=TRAIN_BATCH),
    ]
    bwd = [flash_bwd_case(torch, fa, flush, f"s{s}", s)
           for s in (128, 512, 1024, 2048)]
    bwd += [
        flash_bwd_case(torch, fa, flush, "train", TRAIN_SEQ, b=TRAIN_BATCH),
        flash_bwd_case(torch, fa, flush, "gqa", 512, h=32, hkv=4, d=64),
        flash_bwd_case(torch, fa, flush, "d64", 512, d=64),
        flash_bwd_case(torch, fa, flush, "full", 128, causal=False),
        flash_bwd_case(torch, fa, flush, "ragged", 100),
        flash_bwd_case(torch, fa, flush, "ragged_gqa_d64", 100, h=32, hkv=4,
                       d=64),
        flash_bwd_case(torch, fa, flush, "ragged_full", 100, causal=False),
        flash_bwd_case(torch, fa, flush, "unaligned", 100, offset=1),
        flash_bwd_case(torch, fa, flush, "d32", 128, d=32),   # mma.sync
        flash_bwd_case(torch, fa, flush, "f32", 100, dtype=torch.float32),
    ]
    for c in paged + flash:
        log(f"[kernels] {json.dumps(c)}")
    for c in quant:
        log(f"[kernels] int8 paged {json.dumps(c)}")
    # bench_kernels' MoE layer: 8 x 1024 tokens, top-2 of 8 experts
    d, f, e = MOE_LAYER["d_model"], MOE_LAYER["d_ff"], MOE_LAYER["num_experts"]
    routed = _routed_group_sizes(torch, MOE_BATCH * MOE_SEQ, d, e,
                                 MOE_LAYER["k"], seed=3)
    bf16 = torch.bfloat16
    gmm = [
        gmm_case(torch, gk, flush, "up", bf16, d, f, routed),
        gmm_case(torch, gk, flush, "down", bf16, f, d, routed),
    ]
    gmm += [gmm_case(torch, gk, flush, f"sweep{gs}", bf16, 24, 40, gs)
            for gs in GMM_SWEEP]
    f16 = torch.float16
    gmm += [
        gmm_case(torch, gk, flush, "up_f16", f16, d, f, routed),
        gmm_case(torch, gk, flush, "down_f16", f16, f, d, routed),
        gmm_case(torch, gk, flush, "sweep_f16", f16, 24, 40, GMM_SWEEP[0]),
        # n = 100 rows: off the 64-row tile
        gmm_case(torch, gk, flush, "ragged_n", bf16, 24, 40, [37, 0, 50, 13]),
        gmm_case(torch, gk, flush, "f32", torch.float32, 24, 40,
                 [5, 0, 11, 16]),
        # f32 takes any k and m
        gmm_case(torch, gk, flush, "f32_odd", torch.float32, 12, 10,
                 [3, 2, 5, 1]),
    ]
    gmm_quant = [
        gmm_case(torch, gk, flush, "up_int8", bf16, d, f, routed, quant=True),
        gmm_case(torch, gk, flush, "down_int8", bf16, f, d, routed,
                 quant=True),
        gmm_case(torch, gk, flush, "up_int8_f16", f16, d, f, routed,
                 quant=True),
        gmm_case(torch, gk, flush, "down_int8_f16", f16, f, d, routed,
                 quant=True),
        gmm_case(torch, gk, flush, "sweep_int8", bf16, 24, 40,
                 [0, 7, 1, 24], quant=True),
        gmm_case(torch, gk, flush, "f32_int8", torch.float32, 24, 40,
                 [5, 0, 11, 16], quant=True),
    ]
    # the JAX sweeps' groups at m 48, the nearest width the int8 wgmma
    # kernel's tensor map takes (m % 16 == 0): both int8 kernels held
    gmm_quant += [gmm_case(torch, gk, flush, f"sweep_int8_m48{gs}", bf16,
                           24, 48, gs, quant=True) for gs in GMM_SWEEP]
    # the fused KV write at the serving decode shape (8 slots) and a
    # 512-token prefill, float (bf16, f16, f32) and int8 pools
    kvw = [kv_write_case(torch, kw, flush, f"{mode}_{pool}", dtype, n,
                         mode == "prefill", pool == "int8")
           for mode, n in (("decode", 8), ("prefill", 512))
           for pool, dtype in (("bf16", torch.bfloat16),
                               ("int8", torch.bfloat16),
                               ("f16", torch.float16),
                               ("f32", torch.float32))]
    kvw.append(kv_write_case(torch, kw, flush, "decode_int8_f16",
                             torch.float16, 8, False, True))
    return (paged, flash, bwd, gate_faults(torch, fa), quant, gmm,
            gmm_quant, kvw)


# ---------------------------------------------------------------- parity
def phase_parity(torch):
    """Tiny f32 Llama (MHA and GQA), captured engine: greedy outputs equal
    ``generate``'s, with one decode program and at most one prefill
    program per bucket; the same with ``decode_kernel="xla"`` (the plain
    paged attention captured, counted once per layer per decode step).
    Then a seeded sampled request's first token does not depend on the
    engine's history (``SamplingParams(seed=)``: a busy engine and a fresh
    one under another engine seed agree)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    rng = np.random.default_rng(42)
    lens = [int(n) for n in rng.choice([4, 7, 10, 13], 12)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [20 - n for n in lens]
    geo = dict(max_batch_slots=4, max_model_len=32, page_size=4,
               num_blocks=12, prefill_buckets=[16, 32])
    result = {}
    for kv in (None, 2):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(num_key_value_heads=kv), seed=0
        )
        refs = [model.generate(torch.tensor([p], device="cuda"),
                               max_new_tokens=k)[0, len(p):].tolist()
                for p, k in zip(prompts, max_new)]
        for kernel in ("auto", "xla"):
            engine = Engine(model, EngineConfig(**geo, decode_kernel=kernel))
            _build.reset_launch_counts()
            outs = engine.generate(
                prompts, [SamplingParams(max_new_tokens=k) for k in max_new]
            )
            counts = _build.launch_counts()
            m = engine.metrics
            tag = f"parity kv_heads={kv or 4} decode_kernel={kernel}"
            for o, ref in zip(outs, refs):
                check(o.token_ids == ref,
                      f"{tag}: engine {o.token_ids} != generate {ref}")
            check(engine.block_manager.num_used == 0, f"{tag}: block leak")
            L = model.config.num_hidden_layers
            plain = counts["paged_attention_ref"]
            check(m.decode_compiles == 1 and m.prefill_compiles <= 2
                  and (plain, counts["paged_attention"]) == (
                      (m.decode_steps * L, 0) if kernel == "xla"
                      else (0, m.decode_steps * L)),
                  f"{tag}: programs {m.decode_compiles} / "
                  f"{m.prefill_compiles}, launches {counts}")
            log(f"[parity] {tag}: {len(prompts)} requests token-identical "
                f"to generate (preemptions={m.preemptions}, programs "
                f"{m.decode_compiles} decode + {m.prefill_compiles} "
                f"prefill, plain paged launches {plain})")
    sp = SamplingParams(max_new_tokens=4, do_sample=True, temperature=0.8,
                        seed=123)
    busy = Engine(model, EngineConfig(**geo, seed=0))
    busy.generate(prompts, [SamplingParams(max_new_tokens=5, do_sample=True)
                            for _ in prompts])
    first = [busy.generate([[1, 2, 3]], sp)[0].token_ids[0]]
    fresh = Engine(model, EngineConfig(**geo, seed=9))
    fresh.generate([[7, 8]], SamplingParams(max_new_tokens=2))
    first.append(fresh.generate([[1, 2, 3]], sp)[0].token_ids[0])
    check(first[0] == first[1],
          f"parity: a seeded request's first token follows engine history "
          f"({first})")
    log(f"[parity] seeded sampled first token {first[0]} on a busy and a "
        f"fresh engine")
    result["seeded_first_tokens"] = first
    return result


# --------------------------------------------------------------- serving
SERVING_CFG = dict(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=12, num_attention_heads=16,
    max_position_embeddings=2048, dtype="bfloat16",
)


def _pool_copy(entries):
    """Clones of a pool's per-layer entries (tensors or int8 pairs)."""
    return [tuple(t.clone() for t in e) if isinstance(e, tuple)
            else e.clone() for e in entries]


def _eager_programs(engine):
    """Make every program ``engine`` builds run its function eagerly over
    the same static buffers instead of replaying its graph (still built
    and captured): private to this script, the measure of what capture
    changes."""
    build = engine._program

    def eager(fn, generator):
        prog = build(fn, generator)
        prog._run = prog.fn
        return prog

    engine._program = eager
    return engine


@contextlib.contextmanager
def host_dispatch_probe():
    """Counts, while inside, the kernel launches made by a wrapper outside
    any program's build (its warm-up and capture: ``record_launches``),
    and the graph replays. In a captured engine every launch comes from a
    replay, so ``direct`` stays 0."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import programs

    state = {"depth": 0, "direct": 0, "replays": 0}
    count, record, replay = (_build.count_launch, _build.record_launches,
                             programs.Program._replay)

    def counted(name, variant=None):
        if state["depth"] == 0:
            state["direct"] += 1
        count(name, variant)

    def recorded(fn):
        state["depth"] += 1
        try:
            return record(fn)
        finally:
            state["depth"] -= 1

    def replayed(self):
        state["replays"] += 1
        return replay(self)

    _build.count_launch, _build.record_launches = counted, recorded
    programs.Program._replay = replayed
    try:
        yield state
    finally:
        _build.count_launch, _build.record_launches = count, record
        programs.Program._replay = replay


def _first_decode(torch, model, ecfg, prompts, compare_plain):
    """Run a warm-up engine over the first 8 ``prompts`` (4 greedy tokens
    each) and return its first decode step's logits (f32, active slots),
    read from the captured decode program's output after its first
    replay. With ``compare_plain`` the same step is also run eagerly with
    the plain attention function (the adapter's ``decode_kernel="xla"``)
    on copies of the pool taken just before the replay, over the
    program's own staged inputs, and the two are compared. The engine
    must build one decode program, and its greedy tokens must equal those
    of a twin engine whose programs run their functions eagerly."""
    from paddle_tpu_torch.serving import Engine, SamplingParams

    warm = Engine(model, ecfg)
    got = {}
    real_launch = warm._launch_decode

    def launch_and_compare(idxs):
        if got:
            return real_launch(idxs)
        kp, vp = _pool_copy(warm.pool.k), _pool_copy(warm.pool.v)
        nxt = real_launch(idxs)
        f = warm._decode_buffers.dev
        active = f["active"] != 0
        out = warm._decode_programs[False].out[1].float()
        got["logits"] = out[active]
        got["finite"] = bool(torch.isfinite(out[active]).all())
        if compare_plain:
            warm.adapter.decode_kernel = "xla"
            try:
                plain = warm.adapter.decode(
                    kp, vp, f["tokens"], f["positions"],
                    f["tables"].view(ecfg.max_batch_slots, -1),
                    active).float()
            finally:
                warm.adapter.decode_kernel = ecfg.decode_kernel
            got["max_abs_err"] = (out - plain)[active].abs().max().item()
            got["logit_absmax"] = plain[active].abs().max().item()
        return nxt

    warm._launch_decode = launch_and_compare
    sp = SamplingParams(max_new_tokens=4)
    captured = [o.token_ids for o in warm.generate(prompts[:8], sp)]
    eager = [o.token_ids for o in _eager_programs(
        Engine(model, ecfg)).generate(prompts[:8], sp)]
    torch.cuda.synchronize()
    check(warm.metrics.decode_compiles == 1,
          f"warm-up: {warm.metrics.decode_compiles} decode programs for an "
          f"all-greedy run")
    check(captured == eager,
          f"warm-up: captured greedy tokens {captured} differ from the "
          f"eager program functions' {eager}")
    bytes_per_token = warm.pool.bytes_per_token()
    del warm
    check(got.get("finite"), "serving: non-finite decode logits")
    return got, bytes_per_token


def _serving_gates(tag, counts, m, probe, L, paged, kv_variant, flash,
                   buckets, decode_programs):
    """The serving phases' launch and program gates, the counts
    replay-accounted: every decode step L paged launches on the cluster
    kernel, every prefill L flash launches (``flash``) and every step L
    kv_write launches; no wrapper launched outside a program's capture,
    one replay per step; ``decode_programs`` decode programs and at most
    one prefill program per bucket."""
    other = ("paged_attention" if paged == "paged_attention_quant"
             else "paged_attention_quant")
    check(counts[paged] == m.decode_steps * L and counts[other] == 0,
          f"{tag}: {paged} launches {counts[paged]} != decode_steps "
          f"{m.decode_steps} x {L}, or {other} launched {counts[other]}")
    check(counts.get(f"{paged}/cluster", 0) == counts[paged]
          and counts.get(f"{paged}/split", 0) == 0,
          f"{tag}: paged launches by kernel {counts}")
    want_flash = m.prefill_steps * L if flash else 0
    check(counts["flash_attention"] == want_flash,
          f"{tag}: flash launches {counts['flash_attention']} != "
          f"{want_flash}")
    steps = m.decode_steps + m.prefill_steps
    check(counts["kv_write"] == steps * L
          and counts.get(f"kv_write/{kv_variant}", 0) == steps * L,
          f"{tag}: kv_write launches {counts['kv_write']} != (decode "
          f"{m.decode_steps} + prefill {m.prefill_steps}) x {L} on the "
          f"{kv_variant} kernel")
    check(counts["paged_attention_ref"] == 0,
          f"{tag}: the plain paged attention ran {counts}")
    check(probe["direct"] == 0 and probe["replays"] == steps,
          f"{tag}: {probe['direct']} launches outside a graph, "
          f"{probe['replays']} replays for {steps} steps")
    check(m.decode_compiles == decode_programs
          and 1 <= m.prefill_compiles <= len(buckets),
          f"{tag}: {m.decode_compiles} decode programs (want "
          f"{decode_programs}), {m.prefill_compiles} prefill programs for "
          f"{len(buckets)} buckets")


def _serve(torch, tag, kv_cache_dtype=None):
    """The full-width bf16 Llama serving 32 requests through
    ``Engine.generate`` with ``kv_cache_dtype``; checks and returns the
    run's counters. The int8 run also measures its first decode step's
    logit gap to the float pool and its bytes per token against it."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    cfg = LlamaConfig(**SERVING_CFG)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"[{tag}] model: {model.num_params() / 1e6:.1f}M params bf16, "
        f"built in {time.perf_counter() - t0:.1f}s")
    n_req, slots, mml = 32, 8, 512
    ecfg = EngineConfig(max_batch_slots=slots, max_model_len=mml,
                        page_size=16, kv_cache_dtype=kv_cache_dtype)
    rng = np.random.RandomState(0)
    prompts = [
        rng.randint(1, cfg.vocab_size, rng.randint(8, mml // 4)).tolist()
        for _ in range(n_req)
    ]
    max_new = [int(rng.randint(mml // 8, mml // 2)) for _ in range(n_req)]
    params = [
        SamplingParams(max_new_tokens=k, do_sample=True, temperature=0.8,
                       top_k=50, top_p=0.95) if i % 4 == 3
        else SamplingParams(max_new_tokens=k)
        for i, k in enumerate(max_new)
    ]

    # warm-up engine: the first 8 prompts, 4 tokens each; its first
    # decode step against the same step with the plain attention function
    compared, bytes_per_token = _first_decode(torch, model, ecfg, prompts,
                                              True)
    check(compared["max_abs_err"] <= LOGITS_TOL,
          f"{tag}: first decode logits differ from the plain attention "
          f"path by {compared['max_abs_err']} > {LOGITS_TOL}")
    log(f"[{tag}] first decode step, kernel vs plain attention: "
        f"max_abs_err {compared['max_abs_err']:.5f} (tolerance "
        f"{LOGITS_TOL}, |logits| max {compared['logit_absmax']:.3f})")
    extra = {}
    if kv_cache_dtype is not None:
        # the same first step over a float (bf16) pool: the prefill
        # attends over the in-flight float K/V either way, so the step's
        # tokens and positions are the same
        flt, flt_bytes = _first_decode(
            torch, model, EngineConfig(max_batch_slots=slots,
                                       max_model_len=mml, page_size=16),
            prompts, False)
        gap = (compared["logits"] - flt["logits"]).abs().max().item()
        extra = {"float_pool_logit_gap": gap,
                 "bytes_per_token": bytes_per_token,
                 "float_pool_bytes_per_token": flt_bytes,
                 "bytes_ratio": bytes_per_token / flt_bytes}
        log(f"[{tag}] first decode step, {kv_cache_dtype} pool vs bf16 "
            f"pool: max abs logit gap {gap:.5f}; bytes per token "
            f"{bytes_per_token:.0f} vs {flt_bytes:.0f} "
            f"({bytes_per_token / flt_bytes:.4f})")
    compared = {k: v for k, v in compared.items() if k != "logits"}

    engine = Engine(model, ecfg)
    # the decode program each step asks for: greedy-only or mixed
    kinds, program = set(), engine._decode_program
    engine._decode_program = lambda any_sample: (
        kinds.add(any_sample), program(any_sample))[1]
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with host_dispatch_probe() as probe:
        t0 = time.perf_counter()
        outs = engine.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    m = engine.metrics
    check(len(outs) == n_req and all(
        o.finish_reason in ("length", "stop") for o in outs),
        f"{tag}: not every request finished")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids),
          f"{tag}: token id out of range")
    check(engine.block_manager.num_used == 0,
          f"{tag}: {engine.block_manager.num_used} KV blocks leaked")
    L = cfg.num_hidden_layers
    paged = "paged_attention_quant" if kv_cache_dtype else "paged_attention"
    # one decode program per kind the steps asked for (a step with a
    # sampled request running takes the mixed one), never more than two
    check(kinds and kinds <= {False, True}, f"{tag}: decode kinds {kinds}")
    _serving_gates(tag, counts, m, probe, L, paged,
                   "int8" if kv_cache_dtype else "float", True,
                   ecfg.prefill_buckets, len(kinds))
    n_tokens = sum(len(o.token_ids) for o in outs)
    ttft = float(np.mean([o.time_to_first_token for o in outs]))
    result = {
        "requests": n_req, "generated_tokens": n_tokens, "seconds": dt,
        "tokens_per_s": n_tokens / dt, "mean_ttft_s": ttft,
        "decode_steps": m.decode_steps, "prefill_steps": m.prefill_steps,
        "decode_compiles": m.decode_compiles,
        "prefill_compiles": m.prefill_compiles,
        "graph_replays": probe["replays"], "preemptions": m.preemptions,
        "decode_kinds": sorted("mixed" if k else "greedy" for k in kinds),
        "pool_high_water": engine.block_manager.high_water,
        "sampled_requests": sum(p.do_sample for p in params),
        "launches": counts, "first_decode_compare": compared, **extra,
    }
    log(f"[{tag}] {n_req} requests x {slots} slots mml={mml}: "
        f"{n_tokens} tokens in {dt:.3f}s -> {n_tokens / dt:.1f} tokens/s, "
        f"mean TTFT {ttft * 1e3:.1f} ms, decode steps {m.decode_steps}, "
        f"prefill steps {m.prefill_steps}, preemptions {m.preemptions}, "
        f"programs {m.decode_compiles} decode ("
        f"{'/'.join(sorted('mixed' if k else 'greedy' for k in kinds))}) + "
        f"{m.prefill_compiles} prefill, {probe['replays']} graph replays, "
        f"no launch outside them")
    log(f"[{tag}] launches {counts}")
    return result


def phase_serving(torch):
    return _serve(torch, "serving")


def phase_serving_int8(torch):
    return _serve(torch, "serving_int8", kv_cache_dtype="int8")


def phase_serving_f16(torch):
    """The serving model in float16, with the float16 pool and the int8
    pool: a few requests through ``Engine.generate``. All finish, no block
    leaks, every decode step runs the (float16-q) paged kernel once per
    layer on the cluster kernel, and the first decode step's logits are
    within ``LOGITS_TOL`` of plain attention. Prefill takes the math
    attention (the flash kernels take f32 and bf16)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**dict(SERVING_CFG, dtype="float16"))
    model = LlamaForCausalLM(cfg, seed=0)
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size, rng.randint(8, 100)).tolist()
               for _ in range(8)]
    result = {"launches": {}}
    for pool in (None, "int8"):
        tag = f"serving_f16{'_int8' if pool else ''}"
        ecfg = EngineConfig(max_batch_slots=8, max_model_len=512,
                            page_size=16, kv_cache_dtype=pool)
        compared, _ = _first_decode(torch, model, ecfg, prompts, True)
        check(compared["max_abs_err"] <= LOGITS_TOL,
              f"{tag}: first decode logits differ from the plain attention "
              f"path by {compared['max_abs_err']} > {LOGITS_TOL}")
        engine = Engine(model, ecfg)
        _build.reset_launch_counts()
        with host_dispatch_probe() as probe:
            outs = engine.generate(prompts,
                                   SamplingParams(max_new_tokens=24))
            torch.cuda.synchronize()
        counts = dict(_build.launch_counts(), **_build.variant_counts())
        m = engine.metrics
        name = "paged_attention_quant" if pool else "paged_attention"
        check(len(outs) == len(prompts) and all(
            o.finish_reason in ("length", "stop") for o in outs)
            and engine.block_manager.num_used == 0,
            f"{tag}: not every request finished, or blocks leaked")
        # float16 prefill takes the math attention: no flash launch
        _serving_gates(tag, counts, m, probe, L, name,
                       "int8" if pool else "float", False,
                       ecfg.prefill_buckets, 1)
        for key, n in counts.items():
            result["launches"][key] = result["launches"].get(key, 0) + n
        compared = {k: v for k, v in compared.items() if k != "logits"}
        result[tag] = {"decode_steps": m.decode_steps,
                       "prefill_steps": m.prefill_steps,
                       "decode_compiles": m.decode_compiles,
                       "prefill_compiles": m.prefill_compiles,
                       "graph_replays": probe["replays"],
                       "generated_tokens": sum(len(o.token_ids)
                                               for o in outs),
                       "first_decode_compare": compared}
        log(f"[{tag}] {len(prompts)} requests: {m.decode_steps} decode "
            f"steps, {counts[name]} {name} launches (cluster); first decode "
            f"step vs plain attention max_abs_err "
            f"{compared['max_abs_err']:.5f}")
        del engine
    del model
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- training
def _lm_loss(model, ids):
    return model(ids, labels=ids)[1]


@contextlib.contextmanager
def plain_attention(fa):
    """Inside: ``FlashAttentionFunction`` runs the plain forward and
    backward instead of the kernels (the comparison runs only)."""
    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_ref
    fa.flash_attention_bwd = fa.flash_attention_bwd_ref
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved


FLASH = ("flash_attention", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")


@contextlib.contextmanager
def counted(module, name):
    """Inside: calls of ``module.<name>`` are counted into the yielded
    one-element list."""
    calls = [0]
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _flash_counts(counts):
    return {n: counts[n] for n in FLASH}


def phase_train_parity(torch):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    from paddle_tpu_torch.ops import scaled_dot_product_attention

    # attention that needs gradients returns a grad_fn on the card, and
    # its backward runs both backward kernels
    q, k, v = (torch.randn(2, 40, 4, 16, device="cuda", requires_grad=True)
               for _ in range(3))
    _build.reset_launch_counts()
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    check(out.grad_fn is not None, "sdpa on CUDA returned no grad_fn")
    out.sum().backward()
    counts = _flash_counts(_build.launch_counts())
    check(counts == {n: 1 for n in FLASH} and all(
        t.grad is not None and bool(t.grad.abs().sum() > 0)
        for t in (q, k, v)),
        f"sdpa backward on CUDA: launches {counts}, q/k/v gradients "
        f"{[t.grad is not None for t in (q, k, v)]}")

    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 128, (4, 100))).to("cuda")
    result = {}
    for kv in (None, 2):
        cfg = LlamaConfig.tiny(num_key_value_heads=kv)

        def run():
            model = LlamaForCausalLM(cfg, seed=0)
            opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                        parameters=model.parameters())
            step = TrainStep(model, _lm_loss, opt)
            return [step(ids).item() for _ in range(10)]

        _build.reset_launch_counts()
        kern = run()
        counts = _flash_counts(_build.launch_counts())
        with plain_attention(fa):
            plain = run()
        L = cfg.num_hidden_layers
        check(counts == {n: 10 * L for n in FLASH},
              f"train_parity: flash launches {counts}, want {10 * L} each")
        rel = max(abs(a - b) / abs(b) for a, b in zip(kern, plain))
        check(rel <= PARITY_LOSS_RTOL,
              f"train_parity kv_heads={kv}: losses {kern} vs plain {plain}"
              f" differ by {rel} > {PARITY_LOSS_RTOL} relative")
        key = f"kv_heads={kv or cfg.num_attention_heads}"
        result[key] = {"losses": kern, "plain_losses": plain,
                       "max_rel_diff": rel}
        log(f"[train_parity] {key}: 10 f32 steps, losses {kern[0]:.6f} -> "
            f"{kern[-1]:.6f}, max relative difference to plain attention "
            f"{rel:.3g}")
    return result


def _profiled_step(torch, step, ids):
    """Device time of one training step, all kernels and the flash ones by
    name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3

    def named(tag):
        return sum(e.self_device_time_total for e in kernels
                   if tag in e.key) / 1e3

    # kernel families by name: cuBLAS GEMMs, the port's flash kernels, the
    # optimizer's multi-tensor (foreach) kernels, and everything else
    # (casts, norms, RoPE, residual adds, the loss, gradient sums)
    def family(key):
        if "nvjet" in key or "gemm" in key.lower() or "cutlass" in key:
            return "gemm"
        if "flash_" in key:
            return "flash"
        if "multi_tensor_apply" in key:
            return "foreach"
        return "other"

    families = {}
    for e in kernels:
        f = family(e.key)
        families[f] = families.get(f, 0.0) + e.self_device_time_total / 1e3
    return {
        "device_ms": total, "families_ms": families,
        "flash_fwd_ms": named("flash_fwd"),
        "flash_bwd_dq_ms": named("flash_bwd_dq"),
        "flash_bwd_dkv_ms": named("flash_bwd_dkv"),
        "kernel_launches": sum(e.count for e in kernels),
        "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[:12]],
    }


def phase_train(torch):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    # free what earlier phases left in reference cycles (the serving
    # engines), so the peak below is the training step's own
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, TRAIN_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    L = TRAIN_CFG["num_hidden_layers"]

    def build(**over):
        model = LlamaForCausalLM(LlamaConfig(**dict(TRAIN_CFG, **over)),
                                 seed=0)
        opt = AdamW(learning_rate=3e-4, weight_decay=0.1,
                    parameters=model.parameters(), multi_precision=True)
        return model, TrainStep(model, _lm_loss, opt)

    def run(step, n):
        _build.reset_launch_counts()
        losses = [step(ids) for _ in range(n)]
        torch.cuda.synchronize()
        return [x.item() for x in losses], _flash_counts(
            _build.launch_counts())

    t0 = time.perf_counter()
    model, step = build()
    torch.cuda.synchronize()
    n_params = model.num_params()
    log(f"[train] model: {n_params / 1e6:.1f}M params bf16, built in "
        f"{time.perf_counter() - t0:.1f}s; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens; {resident / 2**20:.0f} MiB allocated "
        f"before it")

    # first step's loss and gradients, flash kernels vs plain attention
    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        loss = _lm_loss(model, ids)
        loss.backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    loss_k, g_k = loss_and_grads()
    with plain_attention(fa):
        loss_p, g_p = loss_and_grads()
    rel = {n: ((g_k[n] - g_p[n]).norm() / g_p[n].norm().clamp_min(1e-30)
               ).item() for n in g_p}
    del g_k, g_p
    worst = max(rel, key=rel.get)
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          f"train: first-step loss {loss_k} vs plain attention {loss_p}")
    check(all(np.isfinite(list(rel.values()))) and
          rel[worst] <= TRAIN_GRAD_RTOL,
          f"train: gradient of {worst} differs from plain attention by "
          f"{rel[worst]} (relative L2) > {TRAIN_GRAD_RTOL}")
    log(f"[train] first step, kernels vs plain attention: loss {loss_k:.5f}"
        f" vs {loss_p:.5f}; worst gradient relative L2 error "
        f"{rel[worst]:.3g} ({worst}), median "
        f"{float(np.median(list(rel.values()))):.3g}")

    # 1 first step + 3 warm-up + 10 timed, one launch count over all 14;
    # the wgmma dq kernel computes delta, so attention_delta never runs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with counted(fa, "attention_delta") as delta_calls:
        t0 = time.perf_counter()
        losses = [step(ids)]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        losses += [step(ids) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids) for _ in range(10)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 10 * 1e3
    counts = _flash_counts(_build.launch_counts())
    variant_counts = _build.variant_counts()
    check(delta_calls[0] == 0 and all(
        variant_counts.get(f"{n}/wgmma") == 14 * L for n in FLASH),
        f"train: attention_delta ran {delta_calls[0]} times, launches by "
        f"design {variant_counts}: want every flash launch on wgmma")
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(abs(losses[0] - loss_k) <= TRAIN_LOSS_TOL,
          f"train: TrainStep's first loss {losses[0]} != {loss_k}")
    check(counts == {n: 14 * L for n in FLASH},
          f"train: flash launches {counts} over 14 steps, want {L} of "
          f"each per step")
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    # bench.py's accounting: 6N per token plus causal attention
    flops_token = 6 * n_params + 12 * L * TRAIN_CFG["hidden_size"] * \
        TRAIN_SEQ * 0.5
    mfu = tokens_s * flops_token / BF16_FLOPS
    prof = _profiled_step(torch, step, ids)
    flash_ms = (prof["flash_fwd_ms"] + prof["flash_bwd_dq_ms"]
                + prof["flash_bwd_dkv_ms"])
    log(f"[train] first step {first_s:.2f}s; 10 steps: {step_ms:.2f} "
        f"ms/step, {tokens_s:.0f} tokens/s, MFU {mfu * 100:.2f}% of "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    # the profiler may see no device time; the share is then unknown
    prof["flash_share"] = (flash_ms / prof["device_ms"]
                           if prof["device_ms"] else None)
    log(f"[train] profiled step: device {prof['device_ms']:.2f} ms in "
        f"{prof['kernel_launches']} kernels; flash fwd "
        f"{prof['flash_fwd_ms']:.3f} ms, bwd dq "
        f"{prof['flash_bwd_dq_ms']:.3f} ms, bwd dk/dv "
        f"{prof['flash_bwd_dkv_ms']:.3f} ms (share of device time: "
        f"{prof['flash_share']})")
    log("[train] device ms by kernel family: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(prof["families_ms"].items())))
    for name, ms, n in prof["top"]:
        log(f"[train]   {name:80s} {ms:9.3f} ms {n:5d} calls")
    log(f"[train] launches over 14 steps {counts}")
    del step, model
    torch.cuda.empty_cache()

    # recompute: the same first two steps, the forward run twice
    model, step = build(recompute=True)
    torch.cuda.reset_peak_memory_stats()
    rc_losses, rc_counts = run(step, 2)
    want = {"flash_attention": 4 * L, "flash_attention_bwd_dq": 2 * L,
            "flash_attention_bwd_dkv": 2 * L}
    check(rc_counts == want,
          f"train recompute: launches {rc_counts}, want {want}")
    diff = max(abs(a - b) for a, b in zip(rc_losses, losses))
    check(diff <= TRAIN_LOSS_TOL,
          f"train recompute: losses {rc_losses} vs {losses[:2]}")
    rc_peak = torch.cuda.max_memory_allocated()
    log(f"[train] recompute: 2 steps, losses {rc_losses} (max difference "
        f"{diff:.3g}), launches {rc_counts}, peak memory "
        f"{rc_peak / 2**30:.2f} GiB")
    del step, model
    torch.cuda.empty_cache()

    # the plain loss head: full [b, s, vocab] logits and cross_entropy
    model, step = build(fused_loss_chunk=0)
    full_losses, full_counts = run(step, 1)
    check(full_counts == {n: L for n in FLASH},
          f"train fused_loss_chunk=0: launches {full_counts}")
    check(abs(full_losses[0] - losses[0]) <= TRAIN_LOSS_TOL,
          f"train fused_loss_chunk=0: loss {full_losses[0]} vs "
          f"{losses[0]}")
    log(f"[train] fused_loss_chunk=0: loss {full_losses[0]:.5f} vs "
        f"{losses[0]:.5f} fused")
    del step, model
    torch.cuda.empty_cache()
    return {
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "resident_bytes_before": resident,
        "first_step_s": first_s, "step_ms": step_ms,
        "tokens_per_s": tokens_s, "mfu": mfu, "peak_bytes": peak,
        "recompute_peak_bytes": rc_peak, "losses": losses,
        "launches": dict(counts, **variant_counts), "profile": prof,
        "grad_check": {"loss": loss_k, "plain_loss": loss_p,
                       "worst_rel_l2": rel[worst], "worst_param": worst,
                       "median_rel_l2": float(np.median(list(rel.values())))},
        "recompute_losses": rc_losses, "recompute_launches": rc_counts,
        "unfused_loss": full_losses[0],
    }


# ------------------------------------------------------------------- moe
def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def plain_gmm(gk):
    """Inside: ``grouped_matmul`` computes with its plain version (the
    comparison runs only)."""
    saved = gk.grouped_matmul
    gk.grouped_matmul = gk.grouped_matmul_ref
    try:
        yield
    finally:
        gk.grouped_matmul = saved


@contextlib.contextmanager
def int8_on_mma(gk):
    """Inside: int8 rhs takes the mma.sync kernel at every size (the
    comparison's timing only)."""
    saved = gk.INT8_WGMMA_MIN_MACS
    gk.INT8_WGMMA_MIN_MACS = float("inf")
    try:
        yield
    finally:
        gk.INT8_WGMMA_MIN_MACS = saved


def _forward_ms(torch, fn, iters=10):
    """Host-clock ms of ``fn`` ending in a synchronize, after 3 warm-ups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_moe(torch):
    """bench_kernels' MoE layer (ragged and dense, float and int8
    experts) and bench_moe's level-0 Llama MoE forward, bf16. Launches
    on this path: the ragged forward, the int8 forward and the Llama MoE
    forward, each counted from 0; the comparisons and the backward are
    not counted."""
    import copy

    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import grouped_matmul as gk
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_moe_experts

    gc.collect()
    torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    e, k = MOE_LAYER["num_experts"], MOE_LAYER["k"]
    ragged = MoELayer(**MOE_LAYER, impl="ragged", dtype=bf16, seed=0)
    # capacity e / k: the dense path can drop nothing
    dense = MoELayer(**MOE_LAYER, impl="dense", capacity_factor=e / k,
                     dtype=bf16, seed=1)
    dense.load_state_dict(ragged.state_dict())
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(MOE_BATCH, MOE_SEQ, MOE_LAYER["d_model"], generator=g,
                    device="cuda").to(bf16)
    tokens = MOE_BATCH * MOE_SEQ
    path = {}

    def count_into(counts):
        for name, n in counts.items():
            path[name] = path.get(name, 0) + n

    # ragged forward: 3 grouped GEMM launches
    with torch.no_grad():
        _build.reset_launch_counts()
        out, aux = ragged(x)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_into(counts)
        count_into(_build.variant_counts())
        check(counts["grouped_matmul"] == 3,
              f"moe: ragged forward launched {counts}")
        with plain_gmm(gk):
            out_p, aux_p = ragged(x)
        ok, stats = compare(out, out_p)
        check(ok, f"moe: ragged forward vs plain grouped GEMM {stats}")
        del out_p, aux_p
        out_d, aux_d, st_d = dense(x, return_stats=True)
        dense_l2 = _rel_l2(out, out_d)
        check(int(st_d["dropped_assignments"]) == 0 and
              dense_l2 <= MOE_DENSE_L2 and aux.item() == aux_d.item(),
              f"moe: ragged vs dense: relative L2 {dense_l2}, aux "
              f"{aux.item()} vs {aux_d.item()}, dropped "
              f"{int(st_d['dropped_assignments'])}")
    layer_aux = aux.item()
    log(f"[moe] ragged forward: 3 grouped_matmul launches; vs plain "
        f"{json.dumps(stats)}; vs dense relative L2 {dense_l2:.3g}, aux "
        f"{layer_aux:.6f} both")

    # ragged backward, every parameter and the input, kernel vs plain
    wgt = torch.randn(x.shape, generator=g, device="cuda")

    def grads():
        ragged.zero_grad(set_to_none=True)
        xi = x.detach().clone().requires_grad_()
        o, a = ragged(xi)
        ((o.float() * wgt).sum() + a).backward()
        got = {n: p.grad.float() for n, p in ragged.named_parameters()}
        got["input"] = xi.grad.float()
        return got

    g_k = grads()
    with plain_gmm(gk):
        g_p = grads()
    grad_l2 = {n: _rel_l2(g_k[n], g_p[n]) for n in g_p}
    worst = max(grad_l2, key=grad_l2.get)
    check(all(np.isfinite(list(grad_l2.values()))) and
          grad_l2[worst] <= MOE_GRAD_L2,
          f"moe: gradient of {worst} differs from the plain grouped GEMM "
          f"by {grad_l2[worst]} > {MOE_GRAD_L2}")
    ragged.zero_grad(set_to_none=True)
    del g_k, g_p
    log(f"[moe] ragged backward vs plain: relative L2 {json.dumps(grad_l2)}")

    # speed: ragged and dense forward tokens/s (the card's counterpart of
    # bench.py's moe_ragged_vs_dense_speedup)
    with torch.no_grad():
        ragged_ms = _forward_ms(torch, lambda: ragged(x))
        dense_ms = _forward_ms(torch, lambda: dense(x))
    del dense
    speed = {"ragged_ms": ragged_ms, "dense_ms": dense_ms,
             "ragged_tokens_per_s": tokens / ragged_ms * 1e3,
             "dense_tokens_per_s": tokens / dense_ms * 1e3,
             "ragged_vs_dense_speedup": dense_ms / ragged_ms}
    log(f"[moe] forward, {tokens} tokens: ragged {ragged_ms:.3f} ms "
        f"({speed['ragged_tokens_per_s']:.0f} tokens/s), dense "
        f"{dense_ms:.3f} ms ({speed['dense_tokens_per_s']:.0f} tokens/s), "
        f"ragged/dense speedup {speed['ragged_vs_dense_speedup']:.3f}x")

    # int8 experts: 3 grouped_matmul_quant launches, against plain int8
    # and the float layer; a gradient through them raises on the card
    quant = copy.deepcopy(ragged)
    saved = quantize_moe_experts(quant)
    with torch.no_grad():
        _build.reset_launch_counts()
        out_q, _ = quant(x)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_into(counts)
        count_into(_build.variant_counts())
        variants = _build.variant_counts()
        check(counts["grouped_matmul_quant"] == 3
              and variants.get("grouped_matmul_quant/wgmma", 0) == 3,
              f"moe: int8 forward launched {counts} {variants}")
        with plain_gmm(gk):
            out_qp, _ = quant(x)
        ok_q, stats_q = compare(out_q, out_qp)
        int8_l2 = _rel_l2(out_q, out)
        check(ok_q and int8_l2 <= MOE_INT8_L2,
              f"moe: int8 experts vs plain {stats_q}, vs float relative "
              f"L2 {int8_l2}")
        int8_ms = _forward_ms(torch, lambda: quant(x))
        # the same forward on the mma.sync int8 kernel (the wrapper's
        # choice before the int8 wgmma kernel), in the same run
        with int8_on_mma(gk):
            int8_mma_ms = _forward_ms(torch, lambda: quant(x))
    try:
        quant(x.detach().clone().requires_grad_())
    except RuntimeError as err:
        check("inference-only" in str(err), f"moe: int8 grad guard: {err}")
    else:
        raise PhaseError("moe: int8 experts gave an output needing a "
                         "gradient")
    log(f"[moe] int8 experts (saved {saved} bytes): 3 grouped_matmul_quant "
        f"launches (wgmma); vs plain {json.dumps(stats_q)}; vs float "
        f"relative L2 {int8_l2:.4f}; forward {int8_ms:.3f} ms (on the "
        f"mma.sync kernel {int8_mma_ms:.3f} ms); a gradient raises")
    del quant, ragged
    gc.collect()
    torch.cuda.empty_cache()

    # float16: the ragged layer and its int8 experts, 3 launches each on
    # the wgmma kernels, against the plain grouped GEMM
    f16 = {}
    half = MoELayer(**MOE_LAYER, impl="ragged", dtype=torch.float16, seed=0)
    xh = x.to(torch.float16)
    with torch.no_grad():
        for tag, layer, name in (
                ("ragged", half, "grouped_matmul"),
                ("int8", None, "grouped_matmul_quant")):
            if layer is None:
                layer = copy.deepcopy(half)
                quantize_moe_experts(layer)
            _build.reset_launch_counts()
            out_h, _ = layer(xh)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            variants = _build.variant_counts()
            count_into(counts)
            count_into(variants)
            check(counts[name] == 3
                  and variants.get(f"{name}/wgmma", 0) == 3,
                  f"moe: float16 {tag} forward launched {counts} {variants}")
            with plain_gmm(gk):
                out_hp, _ = layer(xh)
            ok_h, stats_h = compare(out_h, out_hp)
            check(ok_h and bool(out_h.isfinite().all()),
                  f"moe: float16 {tag} forward vs plain {stats_h}")
            f16[tag] = {"vs_plain": stats_h,
                        "forward_ms": _forward_ms(torch, lambda: layer(xh)),
                        "vs_bf16_rel_l2": _rel_l2(out_h, out)}
            log(f"[moe] float16 {tag} forward: 3 {name} launches (wgmma); "
                f"vs plain {json.dumps(stats_h)}; forward "
                f"{f16[tag]['forward_ms']:.3f} ms")
            del layer
    del half
    gc.collect()
    torch.cuda.empty_cache()

    # bench_moe level 0: one no-grad forward with labels, 2 x 1024 tokens
    model = LlamaForCausalLM(LlamaConfig(**MOE_LLAMA_CFG), seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, MOE_LLAMA_CFG["vocab_size"], (2, 1024))).to("cuda")
    with torch.no_grad():
        _build.reset_launch_counts()
        _, loss = model(ids, labels=ids)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_into(counts)
        count_into(_build.variant_counts())
        with plain_attention(fa):
            _, loss_p = model(ids, labels=ids)
        _, aux = model.llama(ids)
    L = MOE_LLAMA_CFG["num_hidden_layers"]
    check(counts["flash_attention"] == L,
          f"moe: Llama MoE forward flash launches {counts}, want {L}")
    check(np.isfinite(loss.item()) and
          abs(loss.item() - loss_p.item()) <= TRAIN_LOSS_TOL,
          f"moe: Llama MoE loss {loss.item()} vs plain attention "
          f"{loss_p.item()}")
    llama = {"params": model.num_params(), "loss": loss.item(),
             "plain_loss": loss_p.item(), "aux": aux.item(),
             "launches": counts}
    log(f"[moe] Llama MoE ({model.num_params() / 1e6:.1f}M params bf16, "
        f"{L} layers): loss {loss.item():.5f} (aux {aux.item():.4f}) vs "
        f"{loss_p.item():.5f} with plain attention; launches {counts}")
    del model
    torch.cuda.empty_cache()
    log(f"[moe] launches on the path {path}")
    return {"layer": MOE_LAYER, "tokens": tokens,
            "forward_vs_plain": stats, "dense_rel_l2": dense_l2,
            "aux": layer_aux, "grad_rel_l2": grad_l2,
            "int8_vs_plain": stats_q, "int8_vs_float_rel_l2": int8_l2,
            "int8_bytes_saved": saved, "int8_forward_ms": int8_ms,
            "int8_forward_mma_ms": int8_mma_ms, "float16": f16,
            **speed, "llama_moe": llama, "launches": path}


# host runtime calls that launch device work, as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")


def phase_profile(torch):
    """Where a full-width decode step's time goes, over the bf16 pool and
    the int8 pool, both ways: the decode program replayed (the engine's
    path) and its function run eagerly over the same static buffers
    (``_eager_programs``). torch.profiler over 20 steps with all 8 slots
    decoding: device busy time and kernels per step, and the host's
    launch calls per step (``HOST_LAUNCH_CALLS``: one graph launch a step
    when replayed); then the same 20 steps without the profiler (wall ms
    per step), and 20 runs of the 128-token bucket's prefill program
    (wall ms to a sync). Not part of the default run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    model = LlamaForCausalLM(LlamaConfig(**SERVING_CFG), seed=0)
    result = {}
    for pool in ("bf16", "int8"):
        for way in ("replay", "eager"):
            engine = Engine(model, EngineConfig(
                max_batch_slots=8, max_model_len=512, page_size=16,
                kv_cache_dtype="int8" if pool == "int8" else None))
            if way == "eager":
                _eager_programs(engine)
            rng = np.random.RandomState(0)
            for _ in range(8):
                engine.add_request(rng.randint(1, 32000, 100).tolist(),
                                   SamplingParams(max_new_tokens=200))
            for _ in range(30):   # admit, prefill, warm up
                engine.step()
            # the profiler's own first-use set-up, outside the window
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                engine.step()
            torch.cuda.synchronize()
            n = 20
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    engine.step()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n * 1e3
            events = prof.key_averages()
            # kernels only: an ATen op's own row repeats its kernels' time
            kernels = [e for e in events if e.device_type == DeviceType.CUDA]
            device_us = sum(e.self_device_time_total for e in kernels)
            launches = sum(e.count for e in kernels) / n
            host = {e.key: e.count / n for e in events
                    if e.key in HOST_LAUNCH_CALLS}
            rows = sorted(kernels,
                          key=lambda e: -e.self_device_time_total)[:12]
            # the port's own kernels in the step, by name
            ours = {}
            for e in kernels:
                for name in ("kv_write", "paged_decode"):
                    if name in e.key:
                        us, calls = ours.get(name, (0.0, 0.0))
                        ours[name] = (us + e.self_device_time_total / n,
                                      calls + e.count / n)
            tag = f"{pool} pool, {way}"
            log(f"[profile] {tag}, decode step (8 slots, ~130 cached tokens "
                f"each): wall {wall:.3f} ms/step under the profiler, device "
                f"busy {device_us / n / 1e3:.3f} ms/step in {launches:.0f} "
                f"kernels/step; host launch calls/step {host}; the port's "
                f"kernels (device us, calls)/step {ours}")
            for e in rows:
                log(f"[profile] {e.key[:60]:60s} device "
                    f"{e.self_device_time_total / n:9.1f} us/step, "
                    f"calls/step {e.count / n:6.1f}")
            # the same window without the profiler's overhead
            t0 = time.perf_counter()
            for _ in range(n):
                engine.step()
            torch.cuda.synchronize()
            plain_wall = (time.perf_counter() - t0) / n * 1e3
            log(f"[profile] {tag}, decode step without the profiler: "
                f"{plain_wall:.3f} ms/step")
            # the 128-token bucket's prefill program alone, over the last
            # prefill's staged inputs (a 100-token prompt: it rewrites the
            # same K/V into the same pages), host clock to a sync
            prefill = engine._prefill_programs[128]
            engine._prefill_buffers.stage()
            prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                prefill()
                torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) / n * 1e3
            log(f"[profile] {tag}, prefill of a 100-token prompt (bucket "
                f"128): {prefill_ms:.3f} ms")
            result[f"{pool}_{way}"] = {
                "wall_ms_profiled": wall, "wall_ms": plain_wall,
                "device_busy_ms": device_us / n / 1e3,
                "kernels_per_step": launches,
                "host_launch_calls_per_step": host,
                "port_kernels_us_calls_per_step": ours,
                "prefill_128_ms": prefill_ms}
            del engine
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--phases",
        default="kernels,parity,serving,serving_int8,serving_f16,"
                "train_parity,train,moe",
        help="comma list of kernels, parity, serving, serving_int8, "
             "serving_f16, train_parity, train, moe, profile (default: all "
             "but profile)",
    )
    ap.add_argument("--out", help="write the full report as JSON here")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - {"kernels", "parity", "serving", "serving_int8",
                        "serving_f16", "train_parity", "train", "moe",
                        "profile"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from paddle_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2

    report = {"phases": {}}
    t_start = time.perf_counter()
    try:
        card = device_line()
        log(card)   # name, power limit: exactly as nvidia-smi prints them
        log(f"[device] torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("[device] TF32 off for matmul and cuDNN: f32 phases run in "
            "full f32")
        report["device"] = card

        t0 = time.perf_counter()
        _build.build()
        log(f"[build] {len(_build.KERNELS)} kernels in "
            f"{time.perf_counter() - t0:.1f}s")
        report["build"] = {}
        for name, text in _build.build_logs().items():
            # each kernel's name (mangled), its spills and registers, and
            # warning C7515 where ptxas serialized its wgmmas
            lines = [line.strip() for line in text.splitlines()
                     if "entry function" in line or "registers" in line
                     or "spill" in line or "C7515" in line]
            report["build"][name] = lines
            for line in lines:
                log(f"[build] {name}: {line}")

        runners = {
            "kernels": phase_kernels, "parity": phase_parity,
            "serving": phase_serving, "serving_int8": phase_serving_int8,
            "serving_f16": phase_serving_f16,
            "train_parity": phase_train_parity, "train": phase_train,
            "moe": phase_moe, "profile": phase_profile,
        }
        results, report["phase_seconds"] = {}, {}
        for name, run in runners.items():
            if name not in phases:
                continue
            t0 = time.perf_counter()
            results[name] = run(torch)
            report["phase_seconds"][name] = time.perf_counter() - t0
            log(f"[{name}] phase done in "
                f"{report['phase_seconds'][name]:.1f}s")
        paged = flash = bwd = None
        if "kernels" in results:
            paged, flash, bwd, faults, quant, gmm, gmm_quant, kvw = \
                results.pop("kernels")
            report["phases"]["kernels"] = {
                "paged": paged, "flash": flash, "flash_bwd": bwd,
                "gate_faults": faults, "paged_quant": quant, "gmm": gmm,
                "gmm_quant": gmm_quant, "kv_write": kvw,
            }
            # the wrapper's choice against the previous kernel, same
            # inputs, run and host path: reported, not gated (the small
            # cases are ~0.01 ms), by the mean and by the median, and by
            # the median of the kernels alone (the unaligned flash case
            # without its copies; the backward's dq plus dk/dv kernels)
            for stat in ("ms", "median_ms", "kernel_median_ms"):
                slower = {}
                for c in flash + bwd + gmm + gmm_quant + paged + quant:
                    prev = c.get("prev") or (
                        "fma" if c["dtype"] == "float32" else "mma")
                    now, was = (
                        c["variants"][x].get(stat,
                                             c["variants"][x]["median_ms"])
                        for x in (c["variant"], prev))
                    if now > 1.1 * was:
                        slower[f"{c['case']} ({c['variant']})"] = round(
                            now / was, 3)
                report["phases"]["kernels"][f"slower_than_prev_{stat}"] = \
                    slower
                log(f"[kernels] cases >10% slower on the wrapper's choice "
                    f"than on the previous kernel ({stat}): "
                    f"{slower or 'none'}")
        report["phases"].update(results)
        serving, serving_int8, serving_f16, train, moe = (
            results.get(p) for p in ("serving", "serving_int8",
                                     "serving_f16", "train", "moe"))
        check("jax" not in sys.modules and not any(
            m == "paddle_tpu" or m.startswith("paddle_tpu.")
            for m in sys.modules),
            "the port imported jax or paddle_tpu")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["seconds"] = time.perf_counter() - t_start

    kernels = []
    # launches on each main path: serving (float and int8 pools; float16
    # with both), the 14 counted train steps, and the moe phase's counted
    # forwards
    by_path = {p: r["launches"] if r else {} for p, r in (
        ("serving", serving), ("serving_int8", serving_int8),
        ("serving_f16", serving_f16), ("train", train), ("moe", moe))}

    def launches(name):
        per = {p: c.get(name, 0) for p, c in by_path.items()}
        return {"launches": sum(per.values()), "launches_by_path": per}

    def variant_entry(name, v, case, cases):
        """One device kernel of a function that has several: its launches
        on the main paths, its time at ``case``, its worst error over
        ``cases``."""
        return {"variant": v, **launches(f"{name}/{v}"),
                "max_abs_err": max(c["variants"][v]["max_abs_err"]
                                   for c in cases if v in c["variants"]),
                "ms": case["variants"][v]["ms"],
                "median_ms": case["variants"][v]["median_ms"],
                "shape": case["case"]}

    def paged_entry(name, line, cases):
        """The paged kernel at the serving shape, on the wrapper's choice
        (the cluster kernel; the split-K kernel as prev_ms), and both
        under "variants" with their launches on the main paths."""
        head = cases[0]
        return {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"paddle_tpu/kernels/pallas/paged_attention.py:{line}",
            **launches(name),
            "max_abs_err": max(c["variants"][v]["max_abs_err"]
                               for c in cases for v in PAGED_VARIANTS),
            "variant": head["variant"], "ms": head["ms"],
            "prev_ms": head["prev_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shape": head["case"],
            "variants": [variant_entry(name, v, head, cases)
                         for v in PAGED_VARIANTS],
        }

    if paged is not None:
        kernels.append(paged_entry("paged_attention", 73, paged))
        # the forward at the training shape, on the wrapper's choice
        # (wgmma), the mma.sync kernel there as prev_ms; "variants" lists
        # every device kernel of the function (the f32 FMA one at its own
        # case) with its launches on the main paths
        head = next(c for c in flash
                    if c["case"] == f"s{TRAIN_SEQ}_b{TRAIN_BATCH}")
        f32 = next(c for c in flash if c["dtype"] == "float32")
        kernels.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/kernels/pallas/flash_attention.py:37",
            **launches("flash_attention"),
            "max_abs_err": max(c["max_abs_err"] for c in flash),
            "variant": head["variant"], "ms": head["ms"],
            "prev_ms": head["prev_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "variants": [
                variant_entry("flash_attention", v, case, flash)
                for v, case in (("wgmma", head), ("mma", head),
                                ("fma", f32))],
        })
        # the training shape, on the wrapper's choice (wgmma), the
        # mma.sync kernels there as prev_ms; each kernel alone (the wgmma
        # dq kernel with delta), plain and library times of the whole
        # backward (dq, dk and dv), the function both kernels make up;
        # "variants" lists every design (the f32 FMA one at its own case)
        head = next(c for c in bwd if c["case"] == "train")
        f32 = next(c for c in bwd if c["dtype"] == "float32")
        for part, line in (("dq", 138), ("dkv", 191)):
            grads = ("dq",) if part == "dq" else ("dk", "dv")
            name = f"flash_attention_bwd_{part}"
            kernels.append({
                "name": name, "route": "cuda",
                "source":
                    "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
                "replaces":
                    f"paddle_tpu/kernels/pallas/flash_attention.py:{line}",
                **launches(name),
                "max_abs_err": max(c["max_abs_err"][g] for c in bwd
                                   for g in grads),
                "variant": head["variant"], "ms": head[f"{part}_ms"],
                "median_ms": head["variants"][head["variant"]][
                    f"{part}_median_ms"],
                "prev_ms": head["variants"]["mma"][f"{part}_ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head[f"{part}_bound_ms"],
                "bound_by": head[f"{part}_bound_by"],
                "library_ms": head["library_ms"],
                "shape": f"b{TRAIN_BATCH} h16 d128 s{TRAIN_SEQ} causal",
                "backward_ms": head["ms"],
                "backward_median_ms": head["median_ms"],
                "backward_prev_ms": head["prev_ms"],
                "backward_bound_ms": head["bound_ms"],
                "variants": [{
                    "variant": v, **launches(f"{name}/{v}"),
                    "max_abs_err": max(c["variants"][v]["max_abs_err"][g]
                                       for c in bwd if v in c["variants"]
                                       for g in grads),
                    "ms": case["variants"][v][f"{part}_ms"],
                    "median_ms": case["variants"][v][f"{part}_median_ms"],
                    "shape": case["case"]}
                    for v, case in (("wgmma", head), ("mma", head),
                                    ("fma", f32))],
            })
        kernels.append(paged_entry("paged_attention_quant", 103, quant))
        # the grouped GEMM at the MoE layer's up projection, bf16 rhs
        # (wgmma, the mma.sync kernel as prev_ms; the f32 FMA kernel
        # under "variants") and int8 rhs (the int8 wgmma kernel, the
        # mma.sync kernel as prev_ms)
        f32 = next(c for c in gmm if c["dtype"] == "float32")
        for name, line, cases, variants in (
                ("grouped_matmul", 100, gmm,
                 (("wgmma", gmm[0]), ("mma", gmm[0]), ("fma", f32))),
                ("grouped_matmul_quant", 128, gmm_quant,
                 (("wgmma", gmm_quant[0]), ("mma", gmm_quant[0])))):
            head = cases[0]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/kernels/csrc/grouped_matmul.cu",
                "replaces":
                    f"paddle_tpu/kernels/pallas/grouped_matmul.py:{line}",
                **launches(name),
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "variant": head["variant"], "ms": head["ms"],
                "prev_ms": head["prev_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "shape": f"{head['case']}: n {head['n']}, k {head['k']}, "
                         f"m {head['m']}, e {head['experts']}",
                "variants": [variant_entry(name, v, case, cases)
                             for v, case in variants],
            })
    if paged is not None:
        # the fused KV write at the serving decode shape on the bf16 pool
        # (library: index_put_ of K and V), with each pool type's kernel
        # under "variants" (launches on the main paths, the decode case)
        head = kvw[0]
        kernels.append({
            "name": "kv_write", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/kv_write.cu",
            "replaces": "paddle_tpu/kernels/pallas/paged_attention.py:292 "
                        "(update_pages and quantize_tokens :59: XLA ops, "
                        "no TPU kernel)",
            **launches("kv_write"),
            "max_abs_err": max(c["max_abs_err"] for c in kvw),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": f"{head['case']}: {head['rows']} rows, hkv 16, d 128, "
                     f"page 16",
            "variants": [{
                "variant": v, **launches(f"kv_write/{v}"),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "library_ms": c["library_ms"], "bound_ms": c["bound_ms"],
                "shape": c["case"]}
                for v, c in (("float", head),
                             ("int8", next(c for c in kvw
                                           if c["case"] == "decode_int8")))],
        })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(report, kernels=kernels), f, indent=1)
    log(f"[done] {report['seconds']:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
