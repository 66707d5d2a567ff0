"""Ragged grouped matrix multiply for MoE expert FFNs.

Counterpart of ``paddle_tpu/kernels/pallas/grouped_matmul.py``: rows of
``lhs`` are sorted so each expert's rows form one contiguous segment,
sized by ``group_sizes [e]`` in order, and every expert multiplies only
its own segment against its own weight matrix:

    out[i] = lhs[i] @ rhs[g(i)]      g(i) = the group row i belongs to

Int8 experts: ``rhs`` may be int8 with per-expert-per-output-channel
float32 ``rhs_scales [e, m]`` (weight-only absmax quantization); each
expert's contribution is scaled per column, ``(x @ q) * scale``, which is
``x @ (q * scale)`` without a dense float copy of the weights.

``grouped_matmul`` launches ``csrc/grouped_matmul.cu`` on CUDA tensors
(counted as ``grouped_matmul``, and ``grouped_matmul_quant`` for int8
rhs) and takes the plain PyTorch version ``grouped_matmul_ref`` only for
tensors on the CPU (a fake tensor, the static analyzer's, takes
``kernels._build.fake_launch``). lhs is float32, bfloat16 or float16. Which device
kernel serves is decided from the dtypes and shapes before the launch
(``_gmm_variant``, counted per variant): 16-bit (bf16 or f16) lhs with
rhs of its dtype runs the wgmma/TMA kernel (the mma.sync kernel below
2^25 multiply-adds), with int8 rhs the int8 wgmma kernel (the mma.sync
kernel below its own measured crossover), f32 lhs the FMA kernel. The
float path is differentiable through
``GroupedMatmulFunction``, the counterpart of the JAX custom VJP: the
JAX backward has no kernel (it runs the fallback's contraction), so here
``dlhs = g @ rhs[g(i)]^T`` is the transposed instance of the same kernels
(``_forward(g, rhs, group_sizes, trans_rhs=True)``: rhs read where it
lies, no transposed copy; counted ``grouped_matmul`` under the variants
``wgmma_t``, ``mma_t`` and ``fma_t``; ``grouped_matmul_ref`` on
``rhs.transpose(1, 2)``, a view, on the CPU) and ``drhs`` the
per-segment ``lhs^T g``, ``grouped_matmul_wgrad``: on CUDA tensors
``csrc/grouped_matmul_bwd.cu`` (counted ``grouped_matmul_wgrad`` under
``wgmma``, the Hopper kernel, from ``WGRAD_WGMMA_MIN_MACS``, ``mma``
below it, ``fma`` for f32; ``_wgrad_variant`` picks), which finds each
group's rows from the group sizes on the device, so the backward reads
nothing back to the host; ``_segment_outer``, its plain version, on the
CPU. The int8 path is inference-only: it refuses ``trans_rhs``; on CUDA
it raises when a gradient is needed; on the CPU the plain int8 version
stays differentiable, as ``grouped_matmul_xla`` is in JAX.

Contract: ``sum(group_sizes) == lhs.shape[0]``; rows past the sum are
unspecified (the kernel leaves them unwritten, the plain version zero).
The card's gate for 16-bit lhs: ``k % 8 == 0`` and ``m % 8 == 0`` (the
kernels move whole 16-byte vectors and mask the ragged tails); float32
lhs takes any shape. Outside it the wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _aligned

__all__ = ["grouped_matmul", "grouped_matmul_ref", "grouped_matmul_wgrad",
           "GroupedMatmulFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# device kernels of grouped_matmul_launch's and grouped_matmul_wgrad_launch's
# ``variant`` argument: 0 picks the dtypes' own kernel (f32 FMA, or
# mma.sync for 16-bit lhs); 1 the wgmma kernel (of the rhs type: 16-bit
# or int8)
_VARIANTS = {"fma": 0, "mma": 0, "wgmma": 1}
# the measured crossover in multiply-adds (n k m). Below it the mma.sync
# kernel is ahead: by 8-9 % at n 512 x k 128 x m 256 (16.8M) and x k 136 x
# m 200 (13.9M), 12 % at the JAX sweeps' n 32 x k 24 x m 40; from n 512 x
# k 256 x m 256 (2^25) up the wgmma kernel is: by 2 % there, 15 % at 50M,
# 35 % at 134M. Medians of two turns of chip_sweeps.py gmm_crossover on an
# NVIDIA H100 80GB HBM3 at 700 W. f16 runs the same instructions at the
# same rate, so it takes the same crossover.
WGMMA_MIN_MACS = 1 << 25
# int8 rhs: the int8 wgmma kernel from this many multiply-adds, where it
# is ahead of the mma.sync kernel in every turn: level at 16.8M (1.02x
# its time), 0.85x at 2^25, 0.65x at 134M, 0.45x at the MoE up
# projection (medians of two turns of chip_sweeps.py gmm_crossover, int8
# shapes, on an NVIDIA H100 80GB HBM3 at 700 W); for m % 16 == 0 (the int8
# tensor map's row stride) and at most INT8_WGMMA_MAX_GROUPS experts (the
# work list shares shared memory with the 192 KB ring and buffers)
INT8_WGMMA_MIN_MACS = 1 << 25
INT8_WGMMA_MAX_GROUPS = 128
# the weight gradient: its wgmma kernel from this many multiply-adds (n k
# m), the mma.sync kernel below: level at n 512 x k 1024 x m 256 (2^27;
# 0.0121 ms each), the mma.sync kernel 14-22 % ahead at 4.2M-67M (its
# 128 x 128 tiles fill more SMs where each group has ~64 rows), the wgmma
# kernel 1.42x ahead at 537M and 1.8-2.0x from 2.1G to the MoE up
# projection (medians of two turns of chip_sweeps.py wgrad_crossover on an
# NVIDIA H100 80GB HBM3 at 700 W); and at most WGRAD_WGMMA_MAX_GROUPS
# experts (the work list shares shared memory with the 192 KB ring and
# the 32 KB of output staging: 165 fit)
WGRAD_WGMMA_MIN_MACS = 1 << 27
WGRAD_WGMMA_MAX_GROUPS = 160
_lib = None
_wgrad_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("grouped_matmul")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.grouped_matmul_launch.argtypes = [
            vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp,
        ]
        lib.grouped_matmul_launch.restype = ci
        _lib = lib
    return _lib


def _wgrad_kernel():
    global _wgrad_lib
    if _wgrad_lib is None:
        lib = _build.load("grouped_matmul_bwd")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.grouped_matmul_wgrad_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
        ]
        lib.grouped_matmul_wgrad_launch.restype = ci
        _wgrad_lib = lib
    return _wgrad_lib


def _check(lhs, rhs, group_sizes, rhs_scales):
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(
            f"grouped_matmul: want lhs [n, k] and rhs [e, k, m], got "
            f"{tuple(lhs.shape)}, {tuple(rhs.shape)}"
        )
    e, _, m = rhs.shape
    if group_sizes.shape != (e,):
        raise ValueError(
            f"grouped_matmul: group_sizes {tuple(group_sizes.shape)} must "
            f"be [{e}]"
        )
    if rhs_scales is not None and rhs_scales.shape != (e, m):
        raise ValueError(
            f"grouped_matmul: rhs_scales {tuple(rhs_scales.shape)} must be "
            f"[{e}, {m}]"
        )


def _gmm_variant(lhs_dtype, rhs_dtype, n, k, m, groups=1):
    """The device kernel for these dtypes and shapes: "wgmma" (Hopper:
    TMA, an mbarrier ring, wgmma) for 16-bit lhs with rhs of its dtype
    from ``WGMMA_MIN_MACS`` multiply-adds (so k > 0), and with int8 rhs
    from ``INT8_WGMMA_MIN_MACS`` when m % 16 == 0 and ``groups`` <=
    ``INT8_WGMMA_MAX_GROUPS``; "mma" (mma.sync) for the other 16-bit
    lhs (small or k == 0 products); "fma" for f32 lhs. 16-bit shapes off
    the gate (k or m not a multiple of 8) are refused by ``_launch``
    before this is asked."""
    if lhs_dtype == torch.float32:
        return "fma"
    macs = n * k * m
    if rhs_dtype == torch.int8:
        if (macs >= INT8_WGMMA_MIN_MACS and m % 16 == 0
                and groups <= INT8_WGMMA_MAX_GROUPS):
            return "wgmma"
        return "mma"
    if macs >= WGMMA_MIN_MACS:
        return "wgmma"
    return "mma"


def _refuse_int8_trans(rhs_scales, trans_rhs):
    if trans_rhs and rhs_scales is not None:
        raise ValueError(
            "grouped_matmul: int8 rhs is inference-only and takes no "
            "trans_rhs")


def _variant_id(name, variant):
    if variant not in _VARIANTS:
        raise ValueError(
            f"{name}: variant {variant!r} is not one of "
            f"{sorted(_VARIANTS)}")
    return _VARIANTS[variant]


def _launch(lhs, rhs, group_sizes, rhs_scales, variant=None,
            trans_rhs=False):
    """The kernel on checked CUDA inputs -> [n, m] in lhs's dtype.
    ``variant`` forces a device kernel (``chip_smoke.py`` times them side
    by side); by default ``_gmm_variant`` picks it. ``trans_rhs``: rhs is
    [e, m, k] and each group multiplies by ``rhs[g]^T`` (counted under
    the variant with ``_t``)."""
    _refuse_int8_trans(rhs_scales, trans_rhs)
    dtype = _DTYPES.get(lhs.dtype)
    quant = rhs_scales is not None
    if dtype is None:
        raise TypeError(
            f"grouped_matmul kernel takes float32, bfloat16 or float16 lhs, "
            f"got {lhs.dtype}"
        )
    if quant != (rhs.dtype == torch.int8):
        raise TypeError(
            "grouped_matmul: int8 rhs needs rhs_scales, and rhs_scales "
            "needs int8 rhs"
        )
    if not quant and rhs.dtype != lhs.dtype:
        raise TypeError(
            f"grouped_matmul kernel: rhs {rhs.dtype} must have lhs's dtype "
            f"{lhs.dtype}"
        )
    tensors = [("rhs", rhs), ("group_sizes", group_sizes)]
    if quant:
        tensors.append(("rhs_scales", rhs_scales))
    for name, t in tensors:
        if t.device != lhs.device:
            raise ValueError(
                f"grouped_matmul: {name} is on {t.device}, lhs on "
                f"{lhs.device}"
            )
    n, k = lhs.shape
    e, m = rhs.shape[0], rhs.shape[1 if trans_rhs else 2]
    if trans_rhs and (rhs.dim() != 3 or rhs.shape[2] != k):
        raise ValueError(
            f"grouped_matmul: trans_rhs wants rhs [e, m, {k}], got "
            f"{tuple(rhs.shape)}")
    if dtype != 0 and (k % 8 or m % 8):
        raise ValueError(
            f"grouped_matmul kernel: {lhs.dtype} needs k % 8 == 0 and "
            f"m % 8 == 0, got k {k}, m {m}"
        )
    if variant is None:
        variant = _gmm_variant(lhs.dtype, rhs.dtype, n, k, m, e)
    vid = _variant_id("grouped_matmul", variant)
    if _build.is_fake(lhs):
        # the analyzer's trace: the kernel's output, nothing launched
        name = "grouped_matmul_quant" if quant else "grouped_matmul"
        return _build.fake_launch(
            name, variant + ("_t" if trans_rhs else ""),
            torch.empty((n, m), dtype=lhs.dtype, device=lhs.device),
            reads=[lhs, rhs, group_sizes]
            + ([rhs_scales] if quant else []))
    # whole 16-byte (int8: 8-byte) vectors from the start of each tensor;
    # TMA also needs its base on 16 bytes
    lhs, rhs = _aligned(lhs), _aligned(rhs)
    gs = group_sizes.to(torch.int32).contiguous()
    scales = rhs_scales.float().contiguous() if quant else None
    out = torch.empty((n, m), dtype=lhs.dtype, device=lhs.device)
    lib = _kernel()
    with torch.cuda.device(lhs.device):
        err = lib.grouped_matmul_launch(
            lhs.data_ptr(), rhs.data_ptr(),
            scales.data_ptr() if quant else None, gs.data_ptr(),
            out.data_ptr(), n, k, m, e, dtype, int(quant), vid,
            int(trans_rhs),
            torch.cuda.current_stream(lhs.device).cuda_stream,
        )
    name = "grouped_matmul_quant" if quant else "grouped_matmul"
    if trans_rhs:
        variant += "_t"
    if err:
        raise RuntimeError(
            f"{name} ({variant}) kernel launch failed: CUDA error {err}")
    _build.count_launch(name, variant)
    return out


def _forward(lhs, rhs, group_sizes, rhs_scales=None, trans_rhs=False):
    """Kernel on CUDA tensors, plain version on CPU tensors.
    ``trans_rhs``: rhs is [e, m, k] and the product takes each
    ``rhs[g]^T`` where it lies (the backward's ``dlhs``); the plain
    version gets the transposed view."""
    fake = _build.is_fake(lhs)
    if lhs.device.type == "cpu" and not fake:
        _refuse_int8_trans(rhs_scales, trans_rhs)
        if trans_rhs:
            rhs = rhs.transpose(1, 2)
        return grouped_matmul_ref(lhs, rhs, group_sizes, rhs_scales)
    if lhs.device.type != "cuda" and not fake:
        raise ValueError(f"grouped_matmul: unsupported device {lhs.device}")
    return _launch(lhs, rhs, group_sizes, rhs_scales, trans_rhs=trans_rhs)


def grouped_matmul_ref(lhs, rhs, group_sizes, rhs_scales=None):
    """Plain PyTorch version, the counterpart of ``grouped_matmul_xla``:
    one f32 product per group over its segment (float64 stays float64),
    int8 scales applied per column to the product, the result in lhs's
    dtype. Reads the group sizes on the host. Differentiable."""
    _check(lhs, rhs, group_sizes, rhs_scales)
    n = lhs.shape[0]
    m = rhs.shape[2]
    acc = torch.promote_types(lhs.dtype, torch.float32)
    parts, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        size = max(0, min(int(size), n - start))
        if size:
            y = lhs[start:start + size].to(acc) @ rhs[g].to(acc)
            if rhs_scales is not None:
                y = y * rhs_scales[g].to(acc)
            parts.append(y)
        start += size
    if start < n:
        parts.append(torch.zeros((n - start, m), dtype=acc,
                                 device=lhs.device))
    if not parts:
        return torch.zeros((n, m), dtype=lhs.dtype, device=lhs.device)
    return torch.cat(parts).to(lhs.dtype)


def _segment_outer(lhs, g, group_sizes, e):
    """drhs [e, k, m]: per group, lhs[seg]^T @ g[seg] (the product the JAX
    custom VJP takes from the fallback), in f32 or wider, cast to lhs's
    dtype: ``grouped_matmul_wgrad``'s plain version. One read of the
    group sizes on the host, one product per group."""
    acc = torch.promote_types(lhs.dtype, torch.float32)
    k, m = lhs.shape[1], g.shape[1]
    out = torch.zeros((e, k, m), dtype=acc, device=lhs.device)
    start = 0
    for gi, size in enumerate(group_sizes.tolist()):
        size = max(0, min(int(size), lhs.shape[0] - start))
        if size:
            out[gi] = lhs[start:start + size].to(acc).T @ \
                g[start:start + size].to(acc)
        start += size
    return out.to(lhs.dtype)


def _check_wgrad(lhs, g, group_sizes, e):
    if lhs.dim() != 2 or g.dim() != 2 or g.shape[0] != lhs.shape[0]:
        raise ValueError(
            f"grouped_matmul_wgrad: want lhs [n, k] and g [n, m], got "
            f"{tuple(lhs.shape)}, {tuple(g.shape)}"
        )
    if group_sizes.shape != (e,):
        raise ValueError(
            f"grouped_matmul_wgrad: group_sizes {tuple(group_sizes.shape)} "
            f"must be [{e}]"
        )
    if g.dtype != lhs.dtype:
        raise TypeError(
            f"grouped_matmul_wgrad: g {g.dtype} must have lhs's dtype "
            f"{lhs.dtype}"
        )
    for name, t in (("g", g), ("group_sizes", group_sizes)):
        if t.device != lhs.device:
            raise ValueError(
                f"grouped_matmul_wgrad: {name} is on {t.device}, lhs on "
                f"{lhs.device}"
            )


def _wgrad_variant(dtype, n, k, m, e):
    """The weight gradient's device kernel for these shapes: "wgmma"
    (Hopper: TMA, an mbarrier ring, wgmma) for 16-bit from
    ``WGRAD_WGMMA_MIN_MACS`` multiply-adds with at most
    ``WGRAD_WGMMA_MAX_GROUPS`` groups, "mma" (mma.sync) for the other
    16-bit shapes, "fma" for f32."""
    if dtype == torch.float32:
        return "fma"
    if n * k * m >= WGRAD_WGMMA_MIN_MACS and e <= WGRAD_WGMMA_MAX_GROUPS:
        return "wgmma"
    return "mma"


def _launch_wgrad(lhs, g, group_sizes, e, variant=None):
    """The weight-gradient kernel on checked CUDA inputs -> [e, k, m] in
    lhs's dtype. ``variant`` forces a device kernel (``chip_smoke.py``
    times them side by side); by default ``_wgrad_variant`` picks it."""
    dtype = _DTYPES.get(lhs.dtype)
    if dtype is None:
        raise TypeError(
            f"grouped_matmul_wgrad kernel takes float32, bfloat16 or "
            f"float16, got {lhs.dtype}"
        )
    n, k = lhs.shape
    m = g.shape[1]
    if dtype != 0 and (k % 8 or m % 8):
        raise ValueError(
            f"grouped_matmul_wgrad kernel: {lhs.dtype} needs k % 8 == 0 and "
            f"m % 8 == 0, got k {k}, m {m}"
        )
    if variant is None:
        variant = _wgrad_variant(lhs.dtype, n, k, m, e)
    vid = _variant_id("grouped_matmul_wgrad", variant)
    if _build.is_fake(lhs):
        # the analyzer's trace: the kernel's output, nothing launched
        return _build.fake_launch(
            "grouped_matmul_wgrad", variant,
            torch.empty((e, k, m), dtype=lhs.dtype, device=lhs.device),
            reads=[lhs, g, group_sizes])
    lhs, g = _aligned(lhs), _aligned(g)
    gs = group_sizes.to(torch.int32).contiguous()
    # every tile is stored whole (zeros for an empty group)
    out = torch.empty((e, k, m), dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        err = _wgrad_kernel().grouped_matmul_wgrad_launch(
            lhs.data_ptr(), g.data_ptr(), gs.data_ptr(), out.data_ptr(),
            n, k, m, e, dtype, vid,
            torch.cuda.current_stream(lhs.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"grouped_matmul_wgrad ({variant}) kernel launch failed: CUDA "
            f"error {err}")
    _build.count_launch("grouped_matmul_wgrad", variant)
    return out


def grouped_matmul_wgrad(lhs, g, group_sizes, e):
    """The weight gradient of the ragged grouped GEMM: ``drhs[i] =
    lhs[seg_i]^T @ g[seg_i]`` -> [e, k, m] in lhs's dtype, f32
    accumulation, zeros for an empty group. The kernel on CUDA tensors
    (no read of ``group_sizes`` on the host), ``_segment_outer`` on CPU
    tensors."""
    _check_wgrad(lhs, g, group_sizes, e)
    fake = _build.is_fake(lhs)
    if lhs.device.type == "cpu" and not fake:
        return _segment_outer(lhs, g, group_sizes, e)
    if lhs.device.type != "cuda" and not fake:
        raise ValueError(
            f"grouped_matmul_wgrad: unsupported device {lhs.device}")
    return _launch_wgrad(lhs, g, group_sizes, e)


class GroupedMatmulFunction(torch.autograd.Function):
    """``out = grouped_matmul(lhs, rhs, group_sizes)`` (float rhs) with
    the JAX custom VJP's gradients: ``dlhs`` is the transposed instance
    of the forward's kernels on ``rhs`` as it lies (no copy), ``drhs`` the
    per-segment ``lhs^T g`` (``grouped_matmul_wgrad``). Group sizes get
    no gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return _forward(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        g = g.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _forward(g, rhs, group_sizes, trans_rhs=True)
        if ctx.needs_input_grad[1]:
            drhs = grouped_matmul_wgrad(lhs, g, group_sizes, rhs.shape[0])
        return dlhs, drhs, None


def grouped_matmul(lhs, rhs, group_sizes, rhs_scales=None):
    """Ragged grouped GEMM: ``out[i] = lhs[i] @ rhs[g(i)]``.

    lhs [n, k] rows sorted by group; rhs [e, k, m] stacked expert weights
    (of lhs's dtype, or int8 with ``rhs_scales [e, m]``); group_sizes [e]
    summing to n. Returns [n, m] in lhs's dtype, f32 accumulation on
    every path."""
    _check(lhs, rhs, group_sizes, rhs_scales)
    if rhs_scales is None:
        return GroupedMatmulFunction.apply(lhs, rhs, group_sizes)
    if lhs.device.type != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (lhs, rhs, rhs_scales)):
        raise RuntimeError(
            "grouped_matmul with int8 rhs is inference-only: call it "
            "under torch.no_grad() or with inputs that need no gradient"
        )
    return _forward(lhs, rhs, group_sizes, rhs_scales)
