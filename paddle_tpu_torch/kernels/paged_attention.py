"""Paged (block-table) KV-cache attention for incremental decode.

Counterpart of ``paddle_tpu/kernels/pallas/paged_attention.py``. One
query token per sequence attends over that sequence's pages:

  q            [batch, num_q_heads, head_dim]
  k_pages      [num_kv_heads, num_pages, page_size, head_dim]
  v_pages      [num_kv_heads, num_pages, page_size, head_dim]
  block_tables [batch, pages_per_seq] int32  (logical page i of seq b ->
               physical page block_tables[b, i])
  lengths      [batch] int32  (tokens currently in the cache per sequence)

A sequence with ``lengths[b] == 0`` returns exact zeros. GQA: query heads
are grouped per kv head.

Int8 pages: ``k_pages``/``v_pages`` may instead be ``(pages int8, scales
float32 [num_kv_heads, num_pages, page_size])`` pairs, one scale per
cached token per kv head (``quantize_tokens``, written by
``kernels.kv_write``). Every read dequantizes in attention
(``k = int8 * scale``); no dense float copy of the pool is made.

``paged_attention`` launches the CUDA kernel ``csrc/paged_attention.cu``
(float pages, counted as ``paged_attention``; int8 pairs, counted as
``paged_attention_quant``) on CUDA tensors and takes the plain PyTorch
version ``paged_attention_ref`` only for tensors on the CPU (a fake
tensor, the static analyzer's, takes ``kernels._build.fake_launch``). q is
float32, bfloat16 or float16. Two device kernels compute it, counted per
variant: ``"cluster"`` (the default, ``_paged_variant``: one launch, the
chunks of a sequence's kv head merged through distributed shared memory,
no workspace) and ``"split"`` (the first design: a split-K kernel and
its combine kernel over a per-call workspace, kept for side-by-side
timing). The page write, the JAX ``update_pages``, is
``kernels.kv_write``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_ref", "quantize_tokens",
           "split_pages"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# device kernels of the launch's ``variant`` argument
_VARIANTS = {"cluster": 0, "split": 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.c_float, ci, ci, vp,
        ]
        lib.paged_attention_launch.restype = ci
        lib.paged_attention_quant_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.c_float, ci, ci, vp,
        ]
        lib.paged_attention_quant_launch.restype = ci
        lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci, ci, ci, ci]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_workspace_bytes.argtypes = [ci, ci, ci, ci, ci]
        lib.paged_attention_workspace_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def split_pages(pages):
    """(pages, scales) for an int8 pair, (pages, None) for a float pages
    tensor: the one reading of a pool entry, for this module and the
    serving adapter."""
    if isinstance(pages, (tuple, list)):
        return pages[0], pages[1]
    return pages, None


def quantize_tokens(kv):
    """Per-token-per-head absmax int8 quantization of new cache entries:
    kv [..., d] float -> (q int8 [..., d], scale float32 [...]) with
    ``kv ~ q * scale[..., None]``. The 1e-8 floor keeps all-zero tokens
    exact (q == 0). ``torch.round`` rounds half to even like
    ``jnp.round``, and the expression order is the JAX one, so the int8
    values are bit-identical. Both divisions are IEEE divisions by a
    tensor: on CUDA, PyTorch turns a division by a Python scalar into a
    product with its reciprocal, which may round the scale differently
    from the ``kv_write`` kernel."""
    kf = kv.float()
    amax = torch.clamp_min(kf.abs().amax(dim=-1), 1e-8)
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _check_quant(k_pages, k_scales, v_pages, v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError(
            "paged_attention: k and v pages must both be int8 (pages, "
            "scales) pairs or both float tensors"
        )
    if k_scales is None:
        return
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(
            f"paged_attention: quantized pages must be int8, got "
            f"{k_pages.dtype}/{v_pages.dtype}"
        )
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if s.shape != k_pages.shape[:3]:
            raise ValueError(
                f"paged_attention: {name} {tuple(s.shape)} must be "
                f"[hkv, pages, page_size] = {tuple(k_pages.shape[:3])}"
            )


def _check(q, k_pages, v_pages, block_tables, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_attention: want q [b, hq, d] and k/v pages "
            f"[hkv, pages, page_size, d], got {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    n_q_heads, d = q.shape[1], q.shape[2]
    n_kv_heads = k_pages.shape[0]
    if n_q_heads % n_kv_heads:
        raise ValueError(
            f"num_q_heads ({n_q_heads}) must be divisible by num_kv_heads "
            f"({n_kv_heads})"
        )
    if k_pages.shape[3] != d:
        raise ValueError(
            f"paged_attention: head_dim {d} of q does not match pages "
            f"{k_pages.shape[3]}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError("paged_attention: block_tables must be [batch, P]")
    if lengths.shape != (q.shape[0],):
        raise ValueError("paged_attention: lengths must be [batch]")


def _paged_variant(q_dtype, page_dtype):
    """The device kernel the wrapper launches for these dtypes: the
    cluster kernel for every q (f32, bf16, f16) and page type (q's, or
    int8). The split-K kernel runs only when asked for by name."""
    if q_dtype not in _DTYPES or page_dtype not in (q_dtype, torch.int8):
        raise TypeError(
            f"paged_attention kernel takes float32, bfloat16 or float16 q "
            f"with pages of its dtype or int8 pairs, got {q_dtype}/"
            f"{page_dtype}"
        )
    return "cluster"


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None, variant=None):
    """Decode-mode paged attention -> [batch, num_q_heads, head_dim] in
    ``q``'s dtype. CUDA tensors run the hand-written kernel (f32, bf16 or
    f16 q, pages of q's dtype or int8 pairs, head_dim <= 256) that
    ``variant`` names, by default ``_paged_variant``'s; CPU tensors run
    ``paged_attention_ref``."""
    kq, k_scales = split_pages(k_pages)
    vq, v_scales = split_pages(v_pages)
    _check(q, kq, vq, block_tables, lengths)
    _check_quant(kq, k_scales, vq, v_scales)
    quant = k_scales is not None
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    fake = _build.is_fake(q)
    if q.device.type == "cpu" and not fake:
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, scale=scale)
    k_pages, v_pages = kq, vq
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    page_dtype = torch.int8 if quant else q.dtype
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(
            f"paged_attention kernel takes pages of q's dtype or int8 "
            f"pairs, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    chosen = _paged_variant(q.dtype, page_dtype)   # raises off the table
    variant = chosen if variant is None else variant
    if variant not in _VARIANTS:
        raise ValueError(f"paged_attention: unknown variant {variant!r}")
    if d > 256:
        raise ValueError(f"paged_attention kernel: head_dim {d} > 256")
    named = [("k_pages", k_pages), ("v_pages", v_pages),
             ("block_tables", block_tables), ("lengths", lengths)]
    if quant:
        named += [("k_scales", k_scales), ("v_scales", v_scales)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(
                f"paged_attention: {name} is on {t.device}, q on {q.device}"
            )
        if name.endswith(("pages", "scales")) and not t.is_contiguous():
            raise ValueError(
                f"paged_attention kernel: {name} must be contiguous"
            )
    if quant and (k_scales.dtype != torch.float32
                  or v_scales.dtype != torch.float32):
        raise TypeError("paged_attention kernel: scales must be float32")
    if fake:
        # the analyzer's trace: the kernel's output, nothing launched (the
        # split design's workspace, sized by the library, is left out)
        return _build.fake_launch(
            "paged_attention_quant" if quant else "paged_attention",
            variant, torch.empty_like(q),
            reads=[q] + [t for _, t in named])
    return _launch(q.contiguous(), k_pages, v_pages, k_scales, v_scales,
                   block_tables.to(torch.int32).contiguous(),
                   lengths.to(torch.int32).contiguous(), float(scale),
                   variant)


def _launch(q, k_pages, v_pages, k_scales, v_scales, tables, lens, scale,
            variant):
    """The ``variant`` kernel on checked, contiguous CUDA inputs (int32
    tables and lengths) -> out in q's dtype. The cluster kernel allocates
    nothing but out; the split kernel also a workspace for its chunk
    states. ``chip_smoke.py`` times this alone, without the wrapper's
    checks."""
    quant = k_scales is not None
    batch, n_q_heads, d = q.shape
    n_kv_heads, n_pages, page_size, _ = k_pages.shape
    capacity = tables.shape[1] * page_size
    lib = _kernel()
    smem = lib.paged_attention_smem_bytes(
        n_q_heads // n_kv_heads, d, k_pages.element_size(), page_size,
        capacity, _VARIANTS[variant])
    if smem > 232448:
        raise ValueError(
            f"paged_attention kernel ({variant}): query group "
            f"{n_q_heads // n_kv_heads} x head_dim {d} needs {smem} bytes "
            f"of shared memory"
        )
    out = torch.empty_like(q)
    workspace = None
    if variant == "split":
        # per-chunk softmax states. Freed on return while the kernel may
        # still run: safe because the caching allocator hands the memory
        # only to later work on this same stream
        workspace = torch.empty(
            lib.paged_attention_workspace_bytes(
                batch, n_q_heads, n_kv_heads, d, capacity),
            dtype=torch.uint8, device=q.device,
        )
    geometry = (batch, n_q_heads, n_kv_heads, n_pages, page_size,
                tables.shape[1], d, scale, _DTYPES[q.dtype],
                _VARIANTS[variant])
    ws = workspace.data_ptr() if workspace is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quant:
            err = lib.paged_attention_quant_launch(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr(), v_scales.data_ptr(), tables.data_ptr(),
                lens.data_ptr(), out.data_ptr(), ws, *geometry, stream,
            )
        else:
            err = lib.paged_attention_launch(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                tables.data_ptr(), lens.data_ptr(), out.data_ptr(), ws,
                *geometry, stream,
            )
    name = "paged_attention_quant" if quant else "paged_attention"
    if err:
        raise RuntimeError(
            f"{name} ({variant}) kernel launch failed: CUDA error {err}")
    _build.count_launch(name, variant)
    return out


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale=None):
    """Plain PyTorch version of the same contract (gather + masked
    softmax in f32), the counterpart of ``paged_attention_xla``. Int8
    pairs are dequantized right after the gather."""
    k_pages, k_scales = split_pages(k_pages)
    v_pages, v_scales = split_pages(v_pages)
    batch, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    pages_per_seq = block_tables.shape[1]
    group = n_q_heads // n_kv_heads
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    tables = block_tables.long()
    # gathered logical caches: [batch, hkv, pages_per_seq * page_size, d]
    k = k_pages[:, tables].transpose(0, 1).reshape(
        batch, n_kv_heads, pages_per_seq * page_size, d
    )
    v = v_pages[:, tables].transpose(0, 1).reshape(
        batch, n_kv_heads, pages_per_seq * page_size, d
    )
    if k_scales is not None:
        ks = k_scales[:, tables].transpose(0, 1).reshape(
            batch, n_kv_heads, -1)
        vs = v_scales[:, tables].transpose(0, 1).reshape(
            batch, n_kv_heads, -1)
        k = k.float() * ks[..., None]
        v = v.float() * vs[..., None]
    qg = q.reshape(batch, n_kv_heads, group, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    pos = torch.arange(pages_per_seq * page_size, device=q.device)
    lens = lengths.to(q.device)
    s = s.masked_fill(
        ~(pos[None, None, None, :] < lens[:, None, None, None]),
        float("-inf"),
    )
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    # nothing to attend over: exact zeros (the all-masked softmax is NaN)
    out = torch.where(lens[:, None, None, None] > 0, out, 0.0)
    return out.reshape(batch, n_q_heads, d).to(q.dtype)
