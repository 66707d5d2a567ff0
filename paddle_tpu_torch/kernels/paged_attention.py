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

``paged_attention`` launches the CUDA kernel ``csrc/paged_attention.cu``
on CUDA tensors and takes the plain PyTorch version
``paged_attention_ref`` only for tensors on the CPU. ``update_pages``
writes one token per sequence into the pool IN PLACE (the JAX version
returns new arrays). The int8 pool (``quantize_tokens``) is not ported
yet.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_ref", "rows_below_capacity",
           "update_pages"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.c_float, ci, vp,
        ]
        lib.paged_attention_launch.restype = ci
        lib.paged_attention_smem_bytes.argtypes = [ci, ci]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_workspace_bytes.argtypes = [ci, ci, ci, ci, ci]
        lib.paged_attention_workspace_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


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


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None):
    """Decode-mode paged attention -> [batch, num_q_heads, head_dim] in
    ``q``'s dtype. CUDA tensors run the hand-written kernel (f32 or bf16,
    head_dim <= 256); CPU tensors run ``paged_attention_ref``."""
    _check(q, k_pages, v_pages, block_tables, lengths)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q and pages "
            f"of one dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if d > 256:
        raise ValueError(f"paged_attention kernel: head_dim {d} > 256")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(
                f"paged_attention: {name} is on {t.device}, q on {q.device}"
            )
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention kernel: pages must be contiguous")
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    batch, n_q_heads, _ = q.shape
    n_kv_heads, n_pages, page_size, _ = k_pages.shape
    lib = _kernel()
    smem = lib.paged_attention_smem_bytes(n_q_heads // n_kv_heads, d)
    if smem > 232448:
        raise ValueError(
            f"paged_attention kernel: query group {n_q_heads // n_kv_heads} "
            f"x head_dim {d} needs {smem} bytes of shared memory"
        )
    out = torch.empty_like(q)
    # per-chunk softmax states of the split-K kernel. Freed on return
    # while the kernel may still run: safe because the caching allocator
    # hands the memory only to later work on this same stream
    workspace = torch.empty(
        lib.paged_attention_workspace_bytes(
            batch, n_q_heads, n_kv_heads, d, tables.shape[1] * page_size
        ),
        dtype=torch.uint8, device=q.device,
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), batch, n_q_heads, n_kv_heads, n_pages,
            page_size, tables.shape[1], d, float(scale), dtype, stream,
        )
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch("paged_attention")
    return out


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale=None):
    """Plain PyTorch version of the same contract (gather + masked
    softmax in f32), the counterpart of ``paged_attention_xla``."""
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


def rows_below_capacity(lengths, block_tables, page_size):
    """The batch rows ``update_pages`` may write: those whose ``lengths``
    is below the table's capacity (``pages_per_seq * page_size``), as a
    1-D index tensor. One device-to-host sync, so a caller computes it
    once and passes it to every layer's ``update_pages``."""
    capacity = block_tables.shape[1] * page_size
    return torch.nonzero(lengths < capacity).squeeze(1)


def update_pages(k_pages, v_pages, k_new, v_new, block_tables, lengths,
                 rows):
    """Write one new token per sequence into its current page slot, IN
    PLACE. k_new/v_new: [batch, num_kv_heads, head_dim], the token at
    position ``lengths[b]`` of sequence b. Returns (k_pages, v_pages).

    Only the batch rows in ``rows`` are written, and each must be below
    capacity: pass ``rows_below_capacity(lengths, ...)`` to drop the
    sequences at capacity, as the JAX version does (it routes their
    scatter row out of bounds and XLA drops it; PyTorch raises on an
    out-of-range index)."""
    page_size = k_pages.shape[2]
    pos = lengths[rows].long()
    phys = block_tables[rows, pos // page_size].long()
    slot = pos % page_size
    k_pages[:, phys, slot] = k_new[rows].transpose(0, 1).to(k_pages.dtype)
    v_pages[:, phys, slot] = v_new[rows].transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages
