"""Flash attention, forward and backward.

Counterpart of ``paddle_tpu/kernels/pallas/flash_attention.py``: an
online-softmax forward (``_flash_fwd``) that returns the output and the
per-row logsumexp, a backward (``_flash_bwd``) that recomputes the
probabilities from that logsumexp, and the custom VJP that joins them
(``_flash_core``), here the forward op's registered autograd.

Layout as in the JAX public op: q [batch, sq, heads, d], k/v
[batch, sk, kv_heads, d] with ``heads % kv_heads == 0`` (GQA is read in
place, and dk/dv sum over each kv head's query group); out [batch, sq,
heads, d]; lse [batch, heads, sq] float32. The causal mask is top-left
aligned (query i sees keys j <= i), as in the TPU kernels;
``ops.nn_ops.scaled_dot_product_attention`` sends causal calls here only
when sq == sk. Unlike the TPU kernels, sequence lengths need not be
multiples of the tile.

Both directions are ``torch.library`` custom ops,
``paddle_tpu_torch::flash_attention_fwd`` and
``paddle_tpu_torch::flash_attention_bwd``, opaque to Dynamo, AOTAutograd
and ``torch.export`` (a compiled or exported program holds one node per
call and launches the kernel when it runs). The forward op's autograd
(``register_autograd``) calls ``flash_attention_bwd``. The forward op
launches ``csrc/flash_attention.cu`` and the backward op the two
kernels of ``csrc/flash_attention_bwd.cu`` (dq, and dk/dv) on CUDA
tensors; both take their plain PyTorch versions (``flash_attention_ref``,
``flash_attention_bwd_ref``) only for tensors on the CPU. Their fake
implementations (``register_fake``) give the output shapes to a compile,
an export and the static analyzer, whose recorder makes one
``kernel:<name>/<variant>`` node of each call (``_build.op_node``).
Each has three device designs; ``_fwd_variant`` and ``_bwd_variant``
pick one from the dtype, head dim and lengths before the launch (counted per variant):
"wgmma" (Hopper: TMA, an mbarrier ring and wgmma; 16-bit, d 64 or 128),
"mma" (mma.sync, the other 16-bit head dims), "tf32x3" (f32 at d 64 or
128 on the tensor cores, each product as three TF32 products of split
operands) and "fma" (exact f32, the other f32 head dims). The
16-bit designs have a bf16 and a float16 instance each (one template in
the sources); every launch is also counted under its dtype
(``"<name>/bfloat16"``, ``"<name>/float16"``, ``"<name>/float32"``), so a
run can tell a float16 launch from a bf16 one. The wgmma dq kernel also
computes delta = rowsum(dO * O) for the dk/dv kernel, and so does the
3xTF32 one; the other designs read it from ``attention_delta``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "flash_attention", "flash_attention_fwd",
    "flash_attention_ref", "flash_attention_bwd", "flash_attention_bwd_ref",
    "SUPPORTED_HEAD_DIMS", "BWD_HEAD_DIMS",
]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
# head dims of the wgmma kernels, forward and backward (64 or 128 values
# of d: one or two 128-byte swizzled boxes)
WGMMA_HEAD_DIMS = (64, 128)
# the launch functions' ``variant``: 0 is the dtype's own kernel
_VARIANTS = {"fma": 0, "mma": 0, "wgmma": 1, "tf32x3": 2}
# the backward kernels keep their f32 accumulators in registers: up to
# d = 128 (d = 256 would not fit the f32 kernels' shared memory either)
BWD_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_libs = {}


def _kernel(name):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_attention":
            lib.flash_attention_fwd_launch.argtypes = [
                vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, ci, ci, ci,
                vp,
            ]
            lib.flash_attention_fwd_launch.restype = ci
        else:
            # q, k, v, dout, out (dq) or lse (dk/dv), lse or delta, delta
            # or dk, dq or dv; batch, heads, kv_heads, sq, sk, d; scale;
            # causal, dtype, variant; stream
            args = [vp] * 8 + [ci] * 6 + [cf] + [ci] * 3 + [vp]
            lib.flash_attention_bwd_dq_launch.argtypes = args
            lib.flash_attention_bwd_dq_launch.restype = ci
            lib.flash_attention_bwd_dkv_launch.argtypes = args
            lib.flash_attention_bwd_dkv_launch.restype = ci
        _libs[name] = lib
    return lib


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


def _check_cuda(tensors, head_dims):
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if _DTYPES.get(q.dtype) is None or any(t.dtype != q.dtype
                                           for t in tensors):
        raise TypeError(
            f"flash_attention kernel takes float32, bfloat16 or float16 "
            f"tensors of one dtype, got {[t.dtype for t in tensors]}"
        )
    d = q.shape[-1]
    if d not in head_dims:
        raise ValueError(
            f"flash_attention kernel: head_dim {d} not in {head_dims}"
        )
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: tensors on different devices")


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary (the 16-bit
    and the 3xTF32 kernels stage rows with 16-byte loads or copies; a TMA
    tensor map needs its base there): a copy if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _dtype_name(t):
    """The launch count's dtype key: "bfloat16", "float16", "float32"."""
    return str(t.dtype).removeprefix("torch.")


def _fwd_variant(dtype, d, sq, sk):
    """The forward's device kernel for this dtype, head dim and lengths:
    at d 64 or 128 with keys to read, "wgmma" for bf16 or float16 and
    "tf32x3" for float32; at the other head dims (and sk == 0) "mma" for
    16-bit and "fma" for float32."""
    tensor_cores = d in WGMMA_HEAD_DIMS and sq > 0 and sk > 0
    if dtype == torch.float32:
        return "tf32x3" if tensor_cores else "fma"
    return "wgmma" if tensor_cores else "mma"


def _bwd_variant(dtype, d, sq, sk):
    """The backward's device kernels: the forward's rule (the wgmma and
    the 3xTF32 kernels take the same dtypes, head dims and lengths)."""
    return _fwd_variant(dtype, d, sq, sk)


def flash_attention_fwd(q, k, v, *, causal=True, scale=None):
    """-> (out [b, sq, h, d] in q's dtype, lse [b, h, sq] float32): one
    call of the op ``paddle_tpu_torch::flash_attention_fwd``."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, k, v, bool(causal), float(scale))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return _fwd_impl(q, k, v, causal, scale)


def _fwd_impl(q, k, v, causal, scale):
    """The forward op's body: the kernel on CUDA tensors, the plain
    version on CPU tensors (``chip_smoke.py``'s comparisons swap it)."""
    if q.device.type == "cpu":
        out, lse = flash_attention_ref(q, k, v, causal=causal, scale=scale)
        return out.contiguous(), lse
    _check_cuda((q, k, v), SUPPORTED_HEAD_DIMS)
    q, k, v = (_aligned(t) for t in (q, k, v))
    return _launch_fwd(q, k, v, causal, scale)


@_fwd_op.register_fake
def _(q, k, v, causal, scale):
    if q.device.type != "cpu":
        _check_cuda((q, k, v), SUPPORTED_HEAD_DIMS)
    b, sq, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, sq), dtype=torch.float32))


def _fwd_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale = causal, scale


def _fwd_backward(ctx, do, _dlse):
    """The JAX ``_flash_core`` custom VJP: ``flash_attention_bwd``
    recomputes P from the saved lse; lse takes no gradient."""
    q, k, v, out, lse = ctx.saved_tensors
    return (*flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                 causal=ctx.causal, scale=ctx.scale),
            None, None)


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)
_build.op_node("flash_attention_fwd", lambda q, k, v, *_: (
    "flash_attention", _fwd_variant(q.dtype, q.shape[-1], q.shape[1],
                                    k.shape[1])))


def _launch_fwd(q, k, v, causal, scale, variant=None):
    """The forward kernel on checked, aligned CUDA inputs; ``variant``
    forces a device kernel (``chip_smoke.py`` times the wgmma and the
    mma.sync kernels, and the 3xTF32 and the FMA kernels, side by side),
    by default ``_fwd_variant``'s."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if variant is None:
        variant = _fwd_variant(q.dtype, d, sq, sk)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _kernel("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, sq, sk, d, float(scale),
            int(bool(causal)), _DTYPES[q.dtype], _VARIANTS[variant],
            _stream(q.device),
        )
    _raise_on(err, f"flash_attention ({variant})")
    _build.count_launch("flash_attention", variant, _dtype_name(q))
    return out, lse


def _acc_dtype(t):
    """f32, or the input's own dtype where it is wider (float64 in the
    gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def flash_attention_ref(q, k, v, *, causal=True, scale=None):
    """Plain PyTorch version: f32 scores, top-left causal mask, softmax.
    Returns (out in q's dtype, lse [b, h, sq] float32, or float64 for
    float64 inputs)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    acc = _acc_dtype(q)
    qf = q.transpose(1, 2).to(acc)            # [b, h, sq, d]
    kf = k.transpose(1, 2).to(acc)
    vf = v.transpose(1, 2).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype), lse


def attention_delta(out, do):
    """delta [b, h, sq] = rowsum(do * out) in f32 (outside the kernels, as
    in the JAX ``_flash_bwd``): the plain version's, and the mma.sync and
    FMA kernels'; the wgmma and 3xTF32 dq kernels compute their own."""
    acc = _acc_dtype(out)
    return (do.to(acc) * out.to(acc)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, scale=None):
    """Gradients of ``flash_attention_fwd``'s output: ``out`` and ``lse``
    are the forward's, ``do`` the gradient of ``out``. Returns
    (dq, dk, dv) in the dtypes and shapes of q, k, v: one call of the op
    ``paddle_tpu_torch::flash_attention_bwd``."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(
            f"flash_attention_bwd: out {tuple(out.shape)} and do "
            f"{tuple(do.shape)} must have q's shape {tuple(q.shape)}"
        )
    return torch.ops.paddle_tpu_torch.flash_attention_bwd(
        q, k, v, out, lse, do, bool(causal), float(scale))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_bwd",
                         mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            causal: bool, scale: float
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _bwd_impl(q, k, v, out, lse, do, causal, scale)


def _bwd_impl(q, k, v, out, lse, do, causal, scale):
    """The backward op's body: both kernels on CUDA tensors, the plain
    version on CPU tensors (``chip_smoke.py``'s comparisons swap it)."""
    if q.device.type == "cpu":
        return tuple(g.contiguous() for g in flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal=causal, scale=scale))
    _check_cuda((q, k, v, do, out), BWD_HEAD_DIMS)
    return _bwd(*(_aligned(t) for t in (q, k, v, out)),
                lse.float().contiguous(), _aligned(do), causal, scale)


@_bwd_op.register_fake
def _(q, k, v, out, lse, do, causal, scale):
    if q.device.type != "cpu":
        _check_cuda((q, k, v, do, out), BWD_HEAD_DIMS)
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


_build.op_node("flash_attention_bwd", lambda q, k, v, *_: (
    "flash_attention_bwd", _bwd_variant(q.dtype, q.shape[-1], q.shape[1],
                                        k.shape[1])))


def _bwd(q, k, v, out, lse, do, causal, scale, variant=None):
    """Both backward kernels on checked, aligned CUDA inputs (lse f32
    [b, h, sq]); ``variant`` forces a design (``chip_smoke.py`` times the
    wgmma and the mma.sync kernels, and the 3xTF32 and the FMA kernels,
    side by side), by default
    ``_bwd_variant``'s. The wgmma and the 3xTF32 dq kernels compute delta
    for the dk/dv kernel; the others read ``attention_delta``'s
    (``_delta``)."""
    if variant is None:
        variant = _bwd_variant(q.dtype, q.shape[-1], q.shape[1], k.shape[1])
    delta = _delta(out, do, variant)
    dq = _launch_bwd_dq(q, k, v, do, out, lse, delta, causal, scale, variant)
    dk, dv = _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale, variant)
    return dq, dk, dv


def _delta(out, do, variant):
    """What the dq kernel of ``variant`` takes as delta: for "wgmma" an
    uninitialised f32 [b * h, sq rounded up to 128, 2] buffer, which that
    kernel fills with (lse log2(e), delta) pairs for the dk/dv kernel; for
    "tf32x3" an uninitialised f32 [b, h, sq] buffer, which that kernel
    fills with delta; otherwise ``attention_delta``."""
    b, sq, h, _ = out.shape
    if variant == "wgmma":
        return torch.empty((b * h, -(-sq // 128) * 128, 2),
                           dtype=torch.float32, device=out.device)
    if variant == "tf32x3":
        return torch.empty((b, h, sq), dtype=torch.float32,
                           device=out.device)
    return attention_delta(out, do)


def _bwd_args(q, k, causal, scale, variant):
    b, sq, h, d = q.shape
    return (b, h, k.shape[2], sq, k.shape[1], d, float(scale),
            int(bool(causal)), _DTYPES[q.dtype], _VARIANTS[variant],
            _stream(q.device))


def _launch_bwd_dq(q, k, v, do, out, lse, delta, causal, scale, variant):
    """The dq kernel alone, on checked, aligned CUDA inputs (lse f32
    [b, h, sq], delta as ``_delta`` makes it: the wgmma and the 3xTF32
    kernels fill it from out, do (and lse), the others read it).
    ``chip_smoke.py`` times it by itself."""
    dq = torch.empty_like(q)
    lib = _kernel("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k, causal, scale, variant),
        )
    _raise_on(err, f"flash_attention_bwd_dq ({variant})")
    _build.count_launch("flash_attention_bwd_dq", variant, _dtype_name(q))
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale, variant):
    """The dk/dv kernel alone, on the inputs of ``_launch_bwd_dq`` (delta
    as the dq kernel left it)."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, causal, scale, variant),
        )
    _raise_on(err, f"flash_attention_bwd_dkv ({variant})")
    _build.count_launch("flash_attention_bwd_dkv", variant,
                        _dtype_name(q))
    return dk, dv


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal=True,
                            scale=None):
    """Plain PyTorch version of the backward, the math of the JAX
    ``_flash_bwd``: P = exp(S scale - lse) recomputed from the saved lse,
    delta = rowsum(do * out), dS = P (dP - delta) scale, dq = dS k,
    dk = dS^T q, dv = P^T do; GQA dk/dv summed over each group."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    acc = _acc_dtype(q)
    qf = q.transpose(1, 2).to(acc)                        # [b, h, sq, d]
    kf = k.transpose(1, 2).to(acc).repeat_interleave(group, dim=1)
    vf = v.transpose(1, 2).to(acc).repeat_interleave(group, dim=1)
    dof = do.transpose(1, 2).to(acc)
    lse = lse.to(acc)
    # a row with no visible key (lse = -inf) has no probability mass
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = attention_delta(out, do).to(acc)[..., None]
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if group > 1:
        dk = dk.view(b, hkv, group, sk, d).sum(2)
        dv = dv.view(b, hkv, group, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_attention(q, k, v, *, causal=True, scale=None):
    """q [b, sq, h, d], k/v [b, sk, hkv, d] -> out [b, sq, h, d], with
    gradients for q, k and v through the forward op's autograd
    (``flash_attention_bwd``)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
