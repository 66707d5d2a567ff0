"""Paged KV cache: ref-counted block manager over a preallocated pool.

Counterpart of ``paddle_tpu/serving/kv_cache.py``: ``BlockManager`` whole,
``KVPool`` for float and int8 pools (its snapshot, rebind and spill
helpers wait for their slices). The physical cache is one entry per
layer and per K/V, ``[num_kv_heads, num_blocks + 1, block_size, head_dim]``
— the layout ``kernels.paged_attention`` reads — or, for an int8 pool, an
``(int8 pages, float32 scales [num_kv_heads, num_blocks + 1,
block_size])`` pair; the adapter writes into it in place. Page
``num_blocks`` is the sink page of ``kernels.kv_write``: the block
manager never hands it out, no block table names it, and the pool's byte
counts leave it out. Allocation policy lives in the engine.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device

__all__ = ["BlockManager", "KVPool"]


class BlockManager:
    """Ref-counted free-list over ``num_blocks`` logical blocks of
    ``block_size`` tokens each. LIFO: the most recently freed block is
    allocated first."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}/{block_size}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = [0] * self.num_blocks
        self.high_water = 0   # max blocks ever simultaneously in use

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_used(self):
        return self.num_blocks - len(self._free)

    def utilization(self):
        return self.num_used / self.num_blocks

    def blocks_needed(self, num_tokens):
        """Blocks required to hold ``num_tokens`` cache slots."""
        return -(-int(num_tokens) // self.block_size)

    def ref_count(self, block_id):
        return self._ref[block_id]

    def can_allocate(self, n):
        return len(self._free) >= n

    def allocate(self, n):
        """Take ``n`` blocks off the free-list (refcount 1 each)."""
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {len(self._free)} "
                f"free of {self.num_blocks}"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.high_water = max(self.high_water, self.num_used)
        return out

    def fork(self, block_ids):
        """Share existing blocks with a second owner: refcount++ each."""
        for b in block_ids:
            if self._ref[b] < 1:
                raise RuntimeError(f"fork of free block {b}")
            self._ref[b] += 1

    def free(self, block_ids):
        """Drop one reference per block; a block returns to the free-list
        when its last owner releases it."""
        for b in block_ids:
            if self._ref[b] < 1:
                raise RuntimeError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)


class KVPool:
    """The physical page pool: per layer one K and one V entry of
    ``[num_kv_heads, num_blocks + 1, block_size, head_dim]`` (the last
    page is ``sink_page``, the plain page write's target for the rows it
    must not write; nothing reads it), zeroed, on
    ``device`` (``None``: the CUDA device, through ``resolve_device``, as
    every entry point of the port). Updated in place by the adapter's page
    writes.

    ``quant_dtype="int8"`` makes each entry an int8 ``(pages, scales)``
    pair: ``scales`` float32 ``[num_kv_heads, num_blocks, block_size]``,
    one per cached token per kv head, written beside every page write
    (quantize-on-write) and applied in attention. Zero scales make
    unwritten slots dequantize to exact 0, as the float pool's zeros.
    Per token and head that is ``head_dim`` + 4 bytes instead of
    ``head_dim * itemsize``."""

    def __init__(self, num_layers, num_kv_heads, num_blocks, block_size,
                 head_dim, dtype=torch.float32, device=None,
                 quant_dtype=None):
        if quant_dtype not in (None, "int8"):
            raise ValueError(
                f'KVPool quant_dtype must be None or "int8", got '
                f"{quant_dtype!r}"
            )
        device = resolve_device(device)
        shape = (num_kv_heads, num_blocks + 1, block_size, head_dim)

        def mk():
            if quant_dtype is None:
                return torch.zeros(shape, dtype=dtype, device=device)
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=device))

        self.k = [mk() for _ in range(num_layers)]
        self.v = [mk() for _ in range(num_layers)]
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.sink_page = self.num_blocks
        self.block_size = int(block_size)
        self.dtype = dtype
        self.quant_dtype = quant_dtype
        self.device = device

    def nbytes(self):
        """Bytes of the ``num_blocks`` pages the block manager hands out
        (the sink page left out)."""
        total = 0
        for entry in self.k + self.v:
            for t in (entry if isinstance(entry, tuple) else (entry,)):
                total += t.numel() // t.shape[1] * t.element_size()
        return total * self.num_blocks

    def bytes_per_token(self):
        """Cache bytes per token slot across all layers and kv heads, the
        figure the int8 pool cuts."""
        return self.nbytes() / (self.num_blocks * self.block_size)
