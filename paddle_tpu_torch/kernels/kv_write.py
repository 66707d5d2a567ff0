"""Fused KV-cache page write: N new tokens' K and V into their page slots.

In the JAX package this is ``update_pages`` and ``quantize_tokens``
(``paddle_tpu/kernels/pallas/paged_attention.py:292``, ``:59``), XLA ops
fused into the serving programs. Here it is one hand-written launch per
layer for K and V together (``csrc/kv_write.cu``, counted ``kv_write``
with the variant ``float`` or ``int8``), the fixed-shape page write a
captured serving step needs:

  k_pages, v_pages  [hkv, n_pages, page_size, d] float pages, or int8
                    ``(pages, scales f32 [hkv, n_pages, page_size])`` pairs
  k_new, v_new      [N, hkv, d] float32, bfloat16 or float16
  block_tables      [R, pages_per_seq] int32
  rows, positions   [N] int: token i goes to table row ``rows[i]`` at
                    position ``positions[i]``
  valid             [N] bool

Token i is written only where ``valid[i]`` and ``positions[i]`` is below
the table's capacity (``pages_per_seq * page_size``), into physical page
``block_tables[rows[i], positions[i] // page_size]``, slot
``positions[i] % page_size``. A float pool stores the values in its own
dtype (the new rows must have it); an int8 pool stores
``quantize_tokens`` of each row and its scale in the same slot, bit for
bit. Decode passes rows = slot, position = the slot's cache length and
valid = active; prefill passes row 0, position ``cache_len + t`` and
valid = ``t < length``.

The last physical page of every pool entry is the **sink page**
(``serving.KVPool`` allocates it after its ``num_blocks`` pages and the
block manager never hands it out): the plain version ``kv_write_ref``
routes every row it must not write there, so it stays fixed-shape with
no host sync (JAX drops those rows; PyTorch raises on an out-of-range
index). The kernel writes nothing for those rows. Nothing reads the sink.

``kv_write`` launches the kernel on CUDA tensors and takes
``kv_write_ref`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .paged_attention import quantize_tokens, split_pages

__all__ = ["kv_write", "kv_write_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("kv_write")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kv_write_launch.argtypes = [vp] * 10 + [ci] * 9 + [vp]
        lib.kv_write_launch.restype = ci
        _lib = lib
    return _lib


def _check(kq, ks, vq, vs, k_new, v_new, block_tables, rows, positions,
           valid):
    if (ks is None) != (vs is None):
        raise ValueError(
            "kv_write: k and v pages must both be int8 (pages, scales) "
            "pairs or both float tensors")
    if kq.dim() != 4 or vq.shape != kq.shape:
        raise ValueError(
            f"kv_write: want k/v pages [hkv, pages, page_size, d], got "
            f"{tuple(kq.shape)}, {tuple(vq.shape)}")
    hkv, _, _, d = kq.shape
    n = k_new.shape[0]
    if (k_new.shape != (n, hkv, d) or v_new.shape != k_new.shape):
        raise ValueError(
            f"kv_write: new rows {tuple(k_new.shape)}/{tuple(v_new.shape)} "
            f"must be [N, {hkv}, {d}]")
    if block_tables.dim() != 2:
        raise ValueError("kv_write: block_tables must be [rows, P]")
    for name, t in (("rows", rows), ("positions", positions),
                    ("valid", valid)):
        if t.shape != (n,):
            raise ValueError(f"kv_write: {name} must be [{n}], got "
                             f"{tuple(t.shape)}")
    if ks is not None:
        if kq.dtype != torch.int8 or vq.dtype != torch.int8:
            raise TypeError("kv_write: quantized pages must be int8")
        if ks.shape != kq.shape[:3] or vs.shape != kq.shape[:3]:
            raise ValueError("kv_write: scales must be [hkv, pages, "
                             "page_size]")


def kv_write(k_pages, v_pages, k_new, v_new, block_tables, rows, positions,
             valid):
    """Write the new rows into the pool IN PLACE (see the module). CUDA
    tensors launch ``csrc/kv_write.cu`` (float32, bfloat16 or float16
    rows, a float pool of their dtype or an int8 pool, d <= 256); CPU
    tensors run ``kv_write_ref``."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    _check(kq, ks, vq, vs, k_new, v_new, block_tables, rows, positions,
           valid)
    if k_new.device.type == "cpu":
        kv_write_ref(k_pages, v_pages, k_new, v_new, block_tables, rows,
                     positions, valid)
        return
    if k_new.device.type != "cuda":
        raise ValueError(f"kv_write: unsupported device {k_new.device}")
    quant = ks is not None
    dtype = _DTYPES.get(k_new.dtype)
    if dtype is None or v_new.dtype != k_new.dtype:
        raise TypeError(f"kv_write kernel takes float32, bfloat16 or float16 "
                        f"rows, got {k_new.dtype}/{v_new.dtype}")
    if not quant and kq.dtype != k_new.dtype:
        raise TypeError(f"kv_write kernel: float pages {kq.dtype} must have "
                        f"the new rows' dtype {k_new.dtype}")
    hkv, n_pages, page_size, d = kq.shape
    if d > 256:
        raise ValueError(f"kv_write kernel: head_dim {d} > 256")
    pages = [kq, vq] + ([ks, vs] if quant else [])
    for t in pages + [k_new, v_new, block_tables, rows, positions, valid]:
        if t.device != k_new.device:
            raise ValueError(f"kv_write: a tensor is on {t.device}, the new "
                             f"rows on {k_new.device}")
    if not all(t.is_contiguous() for t in pages):
        raise ValueError("kv_write kernel: pages and scales must be "
                         "contiguous")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    rows = rows.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    vec = int(d % (16 // k_new.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (k_new, v_new, kq, vq)))
    lib = _kernel()
    with torch.cuda.device(k_new.device):
        err = lib.kv_write_launch(
            k_new.data_ptr(), v_new.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None, tables.data_ptr(),
            rows.data_ptr(), positions.data_ptr(), valid.data_ptr(),
            k_new.shape[0], hkv, n_pages, page_size, tables.shape[1], d,
            dtype, int(quant), vec,
            torch.cuda.current_stream(k_new.device).cuda_stream,
        )
    variant = "int8" if quant else "float"
    if err:
        raise RuntimeError(
            f"kv_write ({variant}) kernel launch failed: CUDA error {err}")
    _build.count_launch("kv_write", variant)


def kv_write_ref(k_pages, v_pages, k_new, v_new, block_tables, rows,
                 positions, valid):
    """Plain PyTorch version, fixed-shape and free of host syncs: every
    row is scattered, those it must not write into slot 0 of the sink
    page (the last physical page), so no row selection is needed. Rows
    that collide in the sink leave it holding any one of them."""
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    n_pages, page_size = kq.shape[1], kq.shape[2]
    capacity = block_tables.shape[1] * page_size
    pos = positions.long()
    write = valid.bool() & (pos >= 0) & (pos < capacity)
    pos = torch.where(write, pos, torch.zeros_like(pos))
    phys = block_tables[rows.long(), pos // page_size].long()
    phys = torch.where(write, phys, torch.full_like(phys, n_pages - 1))
    slot = pos % page_size
    for pages, scales, new in ((kq, ks, k_new), (vq, vs, v_new)):
        if scales is None:
            pages[:, phys, slot] = new.transpose(0, 1).to(pages.dtype)
            continue
        q8, sc = quantize_tokens(new)
        pages[:, phys, slot] = q8.transpose(0, 1)
        scales[:, phys, slot] = sc.transpose(0, 1)
