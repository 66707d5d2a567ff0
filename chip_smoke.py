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
               in the working dtype, at the serving shapes and the ones
               listed below; kernel, plain and library times from CUDA
               events, and the bound for the same work.
4. parity   — tiny f32 Llama (MHA and GQA): greedy outputs of the port's
               Engine are token-identical to the port's ``generate``.
5. serving  — full-width bf16 Llama (the repo's serving configuration,
               12 layers, random seeded weights) serving 32 mixed
               requests through ``Engine.generate``: all finish, no KV
               block leaks, each decode step runs the paged kernel once
               per layer and each prefill the flash kernel once per layer,
               and the first decode step's logits agree with the same step
               run with the plain attention function.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. ``--out PATH`` also writes the full report (every case, the
serving counters) as JSON to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
# kernel vs plain version: |out - ref| <= atol + rtol * |ref|. In bf16
# both round the output to bf16 (one ulp is 2^-8 of |x|) and the tensor-
# core flash kernel also rounds P to bf16; in f32 only the summation
# order differs
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}
# first decode step of the full-width bf16 model, paged kernel vs plain
# attention: both round the attention output to bf16, and the 1-ulp
# differences this leaves pass through 12 layers of bf16 matmuls
LOGITS_TOL = 5e-2

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


def cuda_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each timed
    with CUDA events after a write of ``flush`` (bigger than the 50 MB
    L2, so every launch starts from a cold cache and the host's launch
    overhead hides behind the flush)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# --------------------------------------------------------------- kernels
def compare(out, ref):
    """(max abs error, within tolerance, tolerance) of a kernel output
    against its plain version: every element within atol + rtol * |ref|."""
    atol, rtol = TOL[str(out.dtype).split(".")[-1]]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return diff.max().item(), ok, {"atol": atol, "rtol": rtol}


def paged_case(torch, pa, flush, name, dtype, hq, hkv, d, lengths,
               page=16, pages_per_seq=32):
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
    out = pa.paged_attention(q, kp, vp, tables, lens)
    ref = pa.paged_attention_ref(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    err, ok, tol = compare(out, ref)
    zero_ok = all(
        bool((out[i] == 0).all()) for i, n in enumerate(lengths) if n == 0
    )
    check(ok and zero_ok,
          f"paged_attention {name}: max_abs_err {err} outside {tol} or "
          f"length-0 rows not exact zeros")
    ms = cuda_ms(torch, lambda: pa.paged_attention(q, kp, vp, tables, lens),
                 50, flush)
    plain_ms = cuda_ms(
        torch, lambda: pa.paged_attention_ref(q, kp, vp, tables, lens), 10,
        flush)
    item = q.element_size()
    tokens = sum(lengths)
    nbytes = (2 * q.numel() * item              # q in, out
              + 2 * tokens * hkv * d * item     # each cached K/V row once
              + tables.numel() * 4 + b * 4)
    flops = 4 * tokens * hq * d
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    return {
        "case": name, "dtype": str(dtype).split(".")[-1], "batch": b,
        "hq": hq, "hkv": hkv, "d": d, "page_size": page,
        "pages_per_seq": pages_per_seq, "lengths": list(lengths),
        "max_abs_err": err, "tolerance": tol, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
                     else "operations"),
        "bytes": nbytes, "flops": flops,
    }


def flash_case(torch, fa, flush, s, dtype=None, h=16, d=128, b=1,
               offset=0):
    """``offset`` > 0 starts q, k and v that many elements into their
    buffers, off the 16-byte grid the bf16 kernel loads on."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(s)
    n = b * s * h * d
    q, k, v = (torch.randn(n + offset, generator=g, device=dev)
               .to(dtype)[offset:].view(b, s, h, d) for _ in range(3))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, ok, tol = compare(out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    check(ok and lse_err <= 1e-3,
          f"flash_attention s={s}: max_abs_err {err} outside {tol} or lse "
          f"err {lse_err} > 1e-3")
    ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                 20, flush)
    plain_ms = cuda_ms(
        torch, lambda: fa.flash_attention_ref(q, k, v, causal=True), 5, flush)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(
        torch,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        20, flush)
    item = q.element_size()
    nbytes = 4 * q.numel() * item + b * h * s * 4     # q, k, v, out, lse
    flops = 4 * b * h * d * (s * (s + 1) // 2)        # causal pairs only
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    return {
        "case": f"s{s}" + ("_unaligned" if offset else ""), "dtype": str(dtype).split(".")[-1], "batch": b,
        "heads": h, "d": d, "seq": s, "max_abs_err": err,
        "lse_max_abs_err": lse_err, "tolerance": tol, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
                     else "operations"),
        "bytes": nbytes, "flops": flops,
    }


def phase_kernels(torch):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lengths = [0, 1, 15, 16, 17, 200, 511, 512]   # 0, partial, full pages
    paged = [
        paged_case(torch, pa, flush, "serving", torch.bfloat16, 16, 16, 128,
                   lengths),
        paged_case(torch, pa, flush, "gqa", torch.bfloat16, 32, 4, 64,
                   lengths),
        paged_case(torch, pa, flush, "serving_f32", torch.float32, 16, 16,
                   128, lengths),
        # 16 chunks per sequence, most of them empty for the short ones
        paged_case(torch, pa, flush, "long", torch.bfloat16, 16, 16, 128,
                   [2048, 1000, 129, 3], pages_per_seq=128),
        # head dim and page size that take the scalar-load path
        paged_case(torch, pa, flush, "odd", torch.bfloat16, 6, 2, 20,
                   [37, 0, 5], page=5, pages_per_seq=8),
    ]
    flash = [flash_case(torch, fa, flush, s)
             for s in (16, 32, 64, 100, 128, 512, 2048)]
    flash.append(flash_case(torch, fa, flush, 100, dtype=torch.float32))
    flash.append(flash_case(torch, fa, flush, 100, offset=1))
    for c in paged + flash:
        log(f"[kernels] {json.dumps(c)}")
    return paged, flash


# ---------------------------------------------------------------- parity
def phase_parity(torch):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    rng = np.random.default_rng(42)
    lens = [int(n) for n in rng.choice([4, 7, 10, 13], 12)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [20 - n for n in lens]
    for kv in (None, 2):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(num_key_value_heads=kv), seed=0
        )
        engine = Engine(model, EngineConfig(
            max_batch_slots=4, max_model_len=32, page_size=4,
            num_blocks=12, prefill_buckets=[16, 32],
        ))
        outs = engine.generate(
            prompts, [SamplingParams(max_new_tokens=k) for k in max_new]
        )
        for p, k, o in zip(prompts, max_new, outs):
            ref = model.generate(
                torch.tensor([p], device="cuda"), max_new_tokens=k
            )[0, len(p):].tolist()
            check(o.token_ids == ref,
                  f"parity kv_heads={kv}: engine {o.token_ids} != "
                  f"generate {ref}")
        check(engine.block_manager.num_used == 0, "parity: block leak")
        log(f"[parity] kv_heads={kv or 4}: {len(prompts)} requests "
            f"token-identical to generate (preemptions="
            f"{engine.metrics.preemptions})")


# --------------------------------------------------------------- serving
def phase_serving(torch):
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.paged_attention import paged_attention_ref
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
    from paddle_tpu_torch.serving import adapter as adapter_mod

    cfg = LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=12, num_attention_heads=16,
        max_position_embeddings=2048, dtype="bfloat16",
    )
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"[serving] model: {model.num_params() / 1e6:.1f}M params bf16, "
        f"built in {time.perf_counter() - t0:.1f}s")
    n_req, slots, mml = 32, 8, 512
    ecfg = EngineConfig(max_batch_slots=slots, max_model_len=mml,
                        page_size=16)
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

    # warm-up engine: the first 8 prompts, 4 tokens each. Its first
    # decode step is also run once with the plain attention function on
    # copies of the pool, and the logits are compared.
    warm = Engine(model, ecfg)
    compared = {}
    real_decode = warm.adapter.decode

    def decode_and_compare(kp, vp, *args):
        if not compared:
            kp2 = [t.clone() for t in kp]
            vp2 = [t.clone() for t in vp]
            adapter_mod.paged_attention = paged_attention_ref
            try:
                plain = real_decode(kp2, vp2, *args).float()
            finally:
                from paddle_tpu_torch.kernels import paged_attention as pa

                adapter_mod.paged_attention = pa.paged_attention
            out = real_decode(kp, vp, *args)
            active = args[3]
            diff = (out.float() - plain)[active].abs().max().item()
            compared.update(
                max_abs_err=diff,
                finite=bool(torch.isfinite(out[active]).all()),
                logit_absmax=plain[active].abs().max().item(),
            )
            return out
        return real_decode(kp, vp, *args)

    warm.adapter.decode = decode_and_compare
    warm.generate(prompts[:8], SamplingParams(max_new_tokens=4))
    torch.cuda.synchronize()
    check(compared.get("finite"), "serving: non-finite decode logits")
    check(compared["max_abs_err"] <= LOGITS_TOL,
          f"serving: first decode logits differ from the plain attention "
          f"path by {compared['max_abs_err']} > {LOGITS_TOL}")
    log(f"[serving] first decode step, kernel vs plain attention: "
        f"max_abs_err {compared['max_abs_err']:.5f} (tolerance "
        f"{LOGITS_TOL}, |logits| max {compared['logit_absmax']:.3f})")
    del warm

    engine = Engine(model, ecfg)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _build.launch_counts()
    m = engine.metrics
    check(len(outs) == n_req and all(
        o.finish_reason in ("length", "stop") for o in outs),
        "serving: not every request finished")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids),
          "serving: token id out of range")
    check(engine.block_manager.num_used == 0,
          f"serving: {engine.block_manager.num_used} KV blocks leaked")
    L = cfg.num_hidden_layers
    check(counts["paged_attention"] == m.decode_steps * L,
          f"serving: paged launches {counts['paged_attention']} != "
          f"decode_steps {m.decode_steps} x {L}")
    check(counts["flash_attention"] == m.prefill_steps * L,
          f"serving: flash launches {counts['flash_attention']} != "
          f"prefill_steps {m.prefill_steps} x {L}")
    n_tokens = sum(len(o.token_ids) for o in outs)
    ttft = float(np.mean([o.time_to_first_token for o in outs]))
    result = {
        "requests": n_req, "generated_tokens": n_tokens, "seconds": dt,
        "tokens_per_s": n_tokens / dt, "mean_ttft_s": ttft,
        "decode_steps": m.decode_steps, "prefill_steps": m.prefill_steps,
        "preemptions": m.preemptions,
        "pool_high_water": engine.block_manager.high_water,
        "sampled_requests": sum(p.do_sample for p in params),
        "launches": counts, "first_decode_compare": compared,
    }
    log(f"[serving] {n_req} requests x {slots} slots mml={mml}: "
        f"{n_tokens} tokens in {dt:.3f}s -> {n_tokens / dt:.1f} tokens/s, "
        f"mean TTFT {ttft * 1e3:.1f} ms, decode steps {m.decode_steps}, "
        f"prefill steps {m.prefill_steps}, preemptions {m.preemptions}")
    log(f"[serving] launches {counts}")
    return result


def phase_profile(torch):
    """Where a full-width decode step's time goes: torch.profiler over 20
    steps with all 8 slots decoding. Not part of the default run."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    cfg = LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=12, num_attention_heads=16,
        max_position_embeddings=2048, dtype="bfloat16",
    )
    model = LlamaForCausalLM(cfg, seed=0)
    engine = Engine(model, EngineConfig(max_batch_slots=8,
                                        max_model_len=512, page_size=16))
    rng = np.random.RandomState(0)
    for _ in range(8):
        engine.add_request(rng.randint(1, 32000, 100).tolist(),
                           SamplingParams(max_new_tokens=200))
    for _ in range(30):   # admit, prefill, warm up
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
    from torch.autograd import DeviceType

    # kernels only: an ATen op's own row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    log(f"[profile] decode step (8 slots, ~130 cached tokens each): "
        f"wall {wall:.3f} ms/step under the profiler, device busy "
        f"{device_us / n / 1e3:.3f} ms/step in "
        f"{sum(e.count for e in kernels) / n:.0f} kernel launches/step")
    for e in rows:
        log(f"[profile] {e.key[:60]:60s} device "
            f"{e.self_device_time_total / n:9.1f} us/step, calls/step "
            f"{e.count / n:6.1f}")
    # the same window without the profiler's overhead
    t0 = time.perf_counter()
    for _ in range(n):
        engine.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n * 1e3
    log(f"[profile] decode step without the profiler: {plain_wall:.3f} "
        f"ms/step")
    return {"wall_ms_profiled": wall, "wall_ms": plain_wall,
            "device_busy_ms": device_us / n / 1e3,
            "kernel_launches_per_step": sum(e.count for e in kernels) / n}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--phases", default="kernels,parity,serving",
        help="comma list of kernels, parity, serving, profile (default: "
             "the first three)",
    )
    ap.add_argument("--out", help="write the full report as JSON here")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

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
        for name, text in _build.build_logs().items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")

        paged = flash = None
        if "kernels" in phases:
            paged, flash = phase_kernels(torch)
            report["phases"]["kernels"] = {"paged": paged, "flash": flash}
        if "parity" in phases:
            phase_parity(torch)
            report["phases"]["parity"] = "ok"
        serving = None
        if "serving" in phases:
            serving = phase_serving(torch)
            report["phases"]["serving"] = serving
        if "profile" in phases:
            report["phases"]["profile"] = phase_profile(torch)
        check("jax" not in sys.modules and not any(
            m == "paddle_tpu" or m.startswith("paddle_tpu.")
            for m in sys.modules),
            "the port imported jax or paddle_tpu")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["seconds"] = time.perf_counter() - t_start

    kernels = []
    launches = serving["launches"] if serving else {}
    if paged is not None:
        head = paged[0]
        kernels.append({
            "name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/kernels/pallas/paged_attention.py:73",
            "launches": launches.get("paged_attention", 0),
            "max_abs_err": max(c["max_abs_err"] for c in paged),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shape": head["case"], "cases": paged,
        })
        head = next(c for c in flash if c["case"] == "s128")
        kernels.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/kernels/pallas/flash_attention.py:37",
            "launches": launches.get("flash_attention", 0),
            "max_abs_err": max(c["max_abs_err"] for c in flash),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "cases": flash,
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
