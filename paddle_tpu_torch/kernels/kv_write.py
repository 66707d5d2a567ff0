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

``rope_kv_write`` is the write every serving program makes, once a layer:
RoPE folded into it (JAX's ``rope_qk``, ``paddle_tpu/ops/impl/
fused_ops.py:87``, fused by XLA into the same programs). Given q [N, hq,
d], k and v [N, hkv, d] and the angles ``cos``/``sin`` f32 [N, d/2]
(``ops.fused_ops.rope_table`` at the rows' positions, built once per
program), it returns the rotated q and writes the rotated k and the plain
v as ``kv_write`` writes them (and returns the rotated k too with
``want_k``: one-shot prefill attends over it). One launch
(``csrc/kv_write.cu``'s ``rope_kv_write_launch``, counted
``rope_kv_write`` with the variant ``float`` or ``int8``) for CUDA
tensors; ``rope_kv_write_ref`` (``apply_rope``, then ``kv_write_ref``)
for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.fused_ops import apply_rope
from . import _build
from .paged_attention import quantize_tokens, split_pages

__all__ = ["kv_write", "kv_write_ref", "rope_kv_write", "rope_kv_write_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("kv_write")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kv_write_launch.argtypes = [vp] * 10 + [ci] * 9 + [vp]
        lib.kv_write_launch.restype = ci
        lib.rope_kv_write_launch.argtypes = [vp] * 15 + [ci] * 10 + [vp]
        lib.rope_kv_write_launch.restype = ci
        _lib = lib
    return _lib


def _check(kq, ks, vq, vs, k_new, v_new, block_tables, rows, positions,
           valid, name="kv_write"):
    if (ks is None) != (vs is None):
        raise ValueError(
            f"{name}: k and v pages must both be int8 (pages, scales) "
            "pairs or both float tensors")
    if kq.dim() != 4 or vq.shape != kq.shape:
        raise ValueError(
            f"{name}: want k/v pages [hkv, pages, page_size, d], got "
            f"{tuple(kq.shape)}, {tuple(vq.shape)}")
    hkv, _, _, d = kq.shape
    n = k_new.shape[0]
    if (k_new.shape != (n, hkv, d) or v_new.shape != k_new.shape):
        raise ValueError(
            f"{name}: new rows {tuple(k_new.shape)}/{tuple(v_new.shape)} "
            f"must be [N, {hkv}, {d}]")
    if block_tables.dim() != 2:
        raise ValueError(f"{name}: block_tables must be [rows, P]")
    for arg, t in (("rows", rows), ("positions", positions),
                   ("valid", valid)):
        if t.shape != (n,):
            raise ValueError(f"{name}: {arg} must be [{n}], got "
                             f"{tuple(t.shape)}")
    if ks is not None:
        if kq.dtype != torch.int8 or vq.dtype != torch.int8:
            raise TypeError(f"{name}: quantized pages must be int8")
        if ks.shape != kq.shape[:3] or vs.shape != kq.shape[:3]:
            raise ValueError(f"{name}: scales must be [hkv, pages, "
                             "page_size]")


def _kernel_args(name, rows_in, pages, block_tables, rows, positions, valid):
    """What both kernels need of CUDA inputs: the row dtype's code, every
    tensor on one device, the pages contiguous, d <= 256; returns the
    code and the routing tensors as the kernel reads them."""
    kq, ks, vq, vs = pages
    new = rows_in[0]
    quant = ks is not None
    dtype = _DTYPES.get(new.dtype)
    if dtype is None or any(t.dtype != new.dtype for t in rows_in):
        raise TypeError(f"{name} kernel takes float32, bfloat16 or float16 "
                        f"rows, got {[t.dtype for t in rows_in]}")
    if not quant and kq.dtype != new.dtype:
        raise TypeError(f"{name} kernel: float pages {kq.dtype} must have "
                        f"the new rows' dtype {new.dtype}")
    if kq.shape[3] > 256:
        raise ValueError(f"{name} kernel: head_dim {kq.shape[3]} > 256")
    live = [t for t in pages if t is not None]
    for t in [*rows_in, *live, block_tables, rows, positions, valid]:
        if t.device != new.device:
            raise ValueError(f"{name}: a tensor is on {t.device}, the new "
                             f"rows on {new.device}")
    if not all(t.is_contiguous() for t in live):
        raise ValueError(f"{name} kernel: pages and scales must be "
                         "contiguous")
    return dtype, (block_tables.to(torch.int32).contiguous(),
                   rows.to(torch.int32).contiguous(),
                   positions.to(torch.int32).contiguous(),
                   valid.to(torch.bool).contiguous())


def _starts_16_byte_aligned(tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


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
    dtype, (tables, rows, positions, valid) = _kernel_args(
        "kv_write", (k_new, v_new), (kq, ks, vq, vs), block_tables, rows,
        positions, valid)
    quant = ks is not None
    hkv, n_pages, page_size, d = kq.shape
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    vec = int(d % (16 // k_new.element_size()) == 0
              and _starts_16_byte_aligned((k_new, v_new, kq, vq)))
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


def rope_kv_write(q, k, v, cos, sin, k_pages, v_pages, block_tables, rows,
                  positions, valid, *, want_k=False):
    """Rotate q and k by ``cos``/``sin`` and write the rotated k and v
    into the pool IN PLACE (see the module); returns the rotated q
    [N, hq, d], or ``(q, k)`` rotated with ``want_k``. CUDA tensors launch
    ``csrc/kv_write.cu``'s ``rope_kv_write_launch`` (float32, bfloat16 or
    float16 rows, a float pool of their dtype or an int8 pool, even
    d <= 256); CPU tensors run ``rope_kv_write_ref``."""
    name = "rope_kv_write"
    kq, ks = split_pages(k_pages)
    vq, vs = split_pages(v_pages)
    _check(kq, ks, vq, vs, k, v, block_tables, rows, positions, valid,
           name)
    n, hkv, d = k.shape
    if q.dim() != 3 or q.shape[0] != n or q.shape[2] != d or d % 2:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be [{n}, hq, "
                         f"{d}] with an even head_dim")
    for arg, t in (("cos", cos), ("sin", sin)):
        if t.shape != (n, d // 2):
            raise ValueError(f"{name}: {arg} must be [{n}, {d // 2}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
    if q.dtype != k.dtype or v.dtype != k.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v, cos, sin):
        if t.device != q.device:
            raise ValueError(f"{name}: a tensor is on {t.device}, q on "
                             f"{q.device}")
    if q.device.type == "cpu":
        return rope_kv_write_ref(q, k, v, cos, sin, k_pages, v_pages,
                                 block_tables, rows, positions, valid,
                                 want_k=want_k)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    dtype, (tables, rows, positions, valid) = _kernel_args(
        name, (q, k, v), (kq, ks, vq, vs), block_tables, rows, positions,
        valid)
    quant = ks is not None
    _, n_pages, page_size, _ = kq.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    q_out = torch.empty_like(q)
    k_out = torch.empty_like(k) if want_k else None
    stores = (q_out, v, kq, vq) + ((k_out,) if want_k else ())
    vec = int(d % (16 // q.element_size()) == 0
              and _starts_16_byte_aligned(stores))
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.rope_kv_write_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), q_out.data_ptr(),
            k_out.data_ptr() if want_k else None, kq.data_ptr(),
            vq.data_ptr(), ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None, tables.data_ptr(),
            rows.data_ptr(), positions.data_ptr(), valid.data_ptr(), n,
            q.shape[1], hkv, n_pages, page_size, tables.shape[1], d, dtype,
            int(quant), vec, torch.cuda.current_stream(q.device).cuda_stream,
        )
    variant = "int8" if quant else "float"
    if err:
        raise RuntimeError(f"rope_kv_write ({variant}) kernel launch "
                           f"failed: CUDA error {err}")
    _build.count_launch("rope_kv_write", variant)
    return (q_out, k_out) if want_k else q_out


def rope_kv_write_ref(q, k, v, cos, sin, k_pages, v_pages, block_tables,
                      rows, positions, valid, *, want_k=False):
    """Plain PyTorch version: ``apply_rope`` of q and of k, then
    ``kv_write_ref`` of the rotated k and v."""
    q_out, k_out = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    kv_write_ref(k_pages, v_pages, k_out, v, block_tables, rows, positions,
                 valid)
    return (q_out, k_out) if want_k else q_out


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
