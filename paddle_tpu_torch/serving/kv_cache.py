"""Paged KV cache: ref-counted block manager over a preallocated pool.

Counterpart of ``paddle_tpu/serving/kv_cache.py``: ``BlockManager`` whole,
``KVPool`` for float and int8 pools, with ``copy_block`` for the prefix
cache's copy-on-write and the host spill tier's block primitives
(``block_signature``, ``read_blocks``/``write_blocks`` and their
one-block forms ``read_block``/``write_block``). JAX's ``rebind`` has no
counterpart: every write lands in the pool's own tensors in place, whose
addresses the captured step programs hold. The physical cache is one
entry per layer and per K/V,
``[num_kv_heads, num_blocks + 1, block_size, head_dim]`` — the layout
``kernels.paged_attention`` reads — or, for an int8 pool, an ``(int8
pages, float32 scales [num_kv_heads, num_blocks + 1, block_size])``
pair; the adapter writes into it in place. Page ``num_blocks`` is the
sink page of ``kernels.kv_write`` and ``rope_kv_write``: the block
manager never hands it out, no block table names it, the spill tier
never reads or writes it, and the pool's byte counts leave it out.
Allocation policy lives in the engine.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..core.device import resolve_device
from .spill import PinnedSlab

__all__ = ["BlockLayout", "BlockManager", "BlockPayload", "KVPool"]

# dtype names as the JAX package writes them into a block signature
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.int8: "int8"}
_ALIGN = 16   # bytes: every leaf's region in a host block row starts here


def _entry_leaves(entry):
    """(pages,) for a float pool's entry, (pages, scales) for an int8 one."""
    return entry if isinstance(entry, tuple) else (entry,)


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


class BlockLayout:
    """How one KV block lies in host memory: one row of ``row_bytes``
    bytes holding, side by side (k layers, then v layers; per layer the
    entry's leaves), each leaf's block slice ``[num_kv_heads, block_size,
    head_dim]`` (pages) or ``[num_kv_heads, block_size]`` (scales) at a
    16-byte-aligned offset. ``leaves`` lists ``(offset, shape, dtype)`` in
    that order; ``nbytes`` is one block's payload (the leaves, no
    padding), as JAX's ``payload_nbytes`` counts it. Two pools with the
    same ``signature`` share the layout."""

    def __init__(self, signature, num_layers, leaf_specs):
        self.signature = signature
        self.num_layers = num_layers
        self.per_layer = len(leaf_specs)
        self.leaves, off, nbytes = [], 0, 0
        for _side in range(2):
            for _layer in range(num_layers):
                for shape, dtype in leaf_specs:
                    n = int(np.prod(shape)) * dtype.itemsize
                    self.leaves.append((off, shape, dtype))
                    off += -(-n // _ALIGN) * _ALIGN
                    nbytes += n
        self.row_bytes = off
        self.nbytes = nbytes

    def views(self, row):
        """The leaf views of one block row (a uint8 tensor of
        ``row_bytes``), as JAX's snapshot: ``(k_layers, v_layers)``, each
        a tuple over layers of leaf tuples."""
        out = []
        for off, shape, dtype in self.leaves:
            n = int(np.prod(shape)) * dtype.itemsize
            out.append(row[off:off + n].view(dtype).view(shape))
        L, m = self.num_layers, self.per_layer
        layers = [tuple(out[i * m:(i + 1) * m]) for i in range(2 * L)]
        return tuple(layers[:L]), tuple(layers[L:])


class BlockPayload:
    """Host bytes of ``n`` KV blocks in a :class:`BlockLayout`, one row per
    block: ``runs`` are uint8 tensors ``[rows, layout.row_bytes]`` (rows of
    a pinned slab, or one buffer) whose rows, in order, are the blocks.
    Indexing gives a block's JAX-form snapshot (leaf views into the row);
    ``nbytes`` is the payload's bytes as the spill tier counts them.
    ``release()`` hands slab rows back, once; the spill tier calls it when
    it drops the payload, and a caller that took the payload out of the
    tier (``get(pop=True)``) calls it after the restore."""

    def __init__(self, layout, runs, release=None):
        self.layout = layout
        self.runs = list(runs)
        self._release = release
        self._n = sum(r.shape[0] for r in self.runs)

    def __len__(self):
        return self._n

    @property
    def nbytes(self):
        return self._n * self.layout.nbytes

    def __iter__(self):
        return (self.layout.views(row) for run in self.runs for row in run)

    def __getitem__(self, i):
        if not -self._n <= i < self._n:
            raise IndexError(f"block {i} of a {self._n}-block payload")
        i %= self._n
        for run in self.runs:
            if i < run.shape[0]:
                return self.layout.views(run[i])
            i -= run.shape[0]

    def release(self):
        rel, self._release = self._release, None
        if rel is not None:
            rel()


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

        k, v = [], []
        try:
            for _ in range(num_layers):
                k.append(mk())
                v.append(mk())
        except Exception:
            # an allocation that fails part way (out of device memory)
            # releases the layers already built before it propagates
            k.clear()
            v.clear()
            raise
        self.k, self.v = k, v
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.sink_page = self.num_blocks
        self.block_size = int(block_size)
        self.dtype = dtype
        self.quant_dtype = quant_dtype
        self.device = device
        specs = (((num_kv_heads, block_size, head_dim), dtype),)
        if quant_dtype is not None:
            specs = (((num_kv_heads, block_size, head_dim), torch.int8),
                     ((num_kv_heads, block_size), torch.float32))
        per = [[list(shape), _DTYPE_NAMES.get(dt, str(dt))]
               for shape, dt in specs]
        self.layout = BlockLayout(
            json.dumps([self.num_layers, self.block_size,
                        quant_dtype or "none", per], separators=(",", ":")),
            self.num_layers, specs)

    def copy_block(self, src, dst):
        """Copy physical block ``src`` over block ``dst`` in every layer's
        K and V pages (and, in an int8 pool, their scale planes): the
        prefix cache's copy-on-write. ``src`` and ``dst`` are one-element
        int tensors on the pool's device, so the copy can be captured
        into a CUDA graph and replayed for any pair of blocks."""
        src, dst = src.reshape(1).long(), dst.reshape(1).long()
        for t in self._leaves():
            t.index_copy_(1, dst, t.index_select(1, src))

    def nbytes(self):
        """Bytes of the ``num_blocks`` pages the block manager hands out
        (the sink page left out)."""
        total = sum(t.numel() // t.shape[1] * t.element_size()
                    for t in self._leaves())
        return total * self.num_blocks

    def bytes_per_token(self):
        """Cache bytes per token slot across all layers and kv heads, the
        figure the int8 pool cuts."""
        return self.nbytes() / (self.num_blocks * self.block_size)

    def per_chip_nbytes(self):
        """Bytes the pool holds on its one card: the whole pool (the
        port serves a replica on one card; JAX's figure for a sharded
        pool waits for tensor parallelism)."""
        return self.nbytes()

    def bytes_per_token_per_chip(self):
        """Per-card counterpart of :meth:`bytes_per_token` (equal to it on
        one card)."""
        return self.per_chip_nbytes() / (self.num_blocks * self.block_size)

    def block_bytes_per_chip(self):
        """Per-card bytes one KV block occupies: the unit ``health()``'s
        ``kv_headroom_bytes_per_chip`` scales free blocks by."""
        return self.per_chip_nbytes() / self.num_blocks

    # -- host spill primitives (serving/spill.py) ---------------------------
    def block_signature(self):
        """Stable wire form of the per-block layout: layer count, block
        size, quantization, and each leaf's block-slice shape and dtype
        (the JAX package's string for the same geometry). Pools with
        equal signatures exchange spilled blocks whatever their
        ``num_blocks``; the spill tier refuses a restore across differing
        signatures — a miss, never a corruption."""
        return self.layout.signature

    def _leaves(self):
        """Every pool tensor: per layer and K/V, the pages (and an int8
        pool's scales), in the order of ``layout.leaves``."""
        return [t for entry in self.k + self.v for t in _entry_leaves(entry)]

    def _block_index(self, block_ids):
        ids = [int(b) for b in block_ids]
        for b in ids:
            # the sink page is never read or written
            if not 0 <= b < self.num_blocks:
                raise ValueError(
                    f"block {b} outside pool of {self.num_blocks}")
        return torch.tensor(ids, dtype=torch.long, device=self.device)

    def _check_not_capturing(self):
        if (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                "KV block read/write inside a CUDA graph capture")

    def read_blocks(self, block_ids, slab):
        """Host snapshot of the blocks ``block_ids`` as one
        :class:`BlockPayload`, byte for byte, in rows of ``slab`` (a
        ``spill.PinnedSlab``: fixed rows allocated once, so a spill never
        allocates host memory). One ``index_select`` per pool leaf into a
        device staging buffer laid out as the host rows, one
        stream-ordered copy per run of consecutive slab rows, one sync for
        the whole handle. A slab without enough free rows raises: the
        engine sizes its slab so that it cannot run out. The device work
        holds ``programs.capture_lock``: its staging allocation must not
        land inside another thread's capture. Runs on the current stream,
        after every launch queued on it."""
        from .programs import capture_lock

        self._check_not_capturing()
        lay = self.layout
        n = len(block_ids)
        rows = slab.alloc(n)
        if rows is None:
            raise RuntimeError(
                f"read_blocks: {n} blocks, {slab.num_free} free slab rows")
        try:
            with capture_lock:
                idx = self._block_index(block_ids)
                staging = torch.empty((n, lay.row_bytes), dtype=torch.uint8,
                                      device=self.device)
                for leaf, (off, shape, dtype) in zip(self._leaves(),
                                                     lay.leaves):
                    nb = int(np.prod(shape)) * dtype.itemsize
                    dst = staging[:, off:off + nb].view(dtype).view(
                        (n,) + tuple(shape))
                    dst.copy_(leaf.index_select(1, idx).transpose(0, 1))
                runs, i = [], 0
                for start, length in slab.runs(rows):
                    run = slab.rows[start:start + length]
                    run.copy_(staging[i:i + length], non_blocking=True)
                    runs.append(run)
                    i += length
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
        except BaseException:
            slab.free(rows)
            raise
        return BlockPayload(lay, runs, lambda: slab.free(rows))

    def write_blocks(self, block_ids, payload):
        """Write a payload's first ``len(block_ids)`` blocks into the
        blocks ``block_ids``, in place (``index_copy_`` into the pool's
        own tensors, the ones the captured programs hold): the spill
        tier's restore. ``payload`` is a :class:`BlockPayload` in this
        pool's layout, or a list of JAX-form snapshots (``(k_layers,
        v_layers)`` of per-layer leaf tuples, tensors or numpy arrays,
        validated leaf by leaf). The copy is bytewise, so a restored
        block is byte-identical to the block that was read. One
        stream-ordered copy per run of host rows into a device staging
        buffer, one ``index_copy_`` per pool leaf, one sync for the
        handle; under ``programs.capture_lock``, on the current stream,
        so the next replay on it reads the restored pages."""
        from .programs import capture_lock

        self._check_not_capturing()
        lay = self.layout
        n = len(block_ids)
        if len(payload) < n:
            raise ValueError(
                f"write_blocks: {len(payload)} blocks for {n} block ids")
        if not (isinstance(payload, BlockPayload)
                and payload.layout.signature == lay.signature):
            payload = self._pack(payload, n)
        with capture_lock:
            idx = self._block_index(block_ids)
            staging = torch.empty((n, lay.row_bytes), dtype=torch.uint8,
                                  device=self.device)
            i = 0
            for run in payload.runs:
                take = min(run.shape[0], n - i)
                if take <= 0:
                    break
                staging[i:i + take].copy_(run[:take], non_blocking=True)
                i += take
            for leaf, (off, shape, dtype) in zip(self._leaves(),
                                                 lay.leaves):
                nb = int(np.prod(shape)) * dtype.itemsize
                src = staging[:, off:off + nb].view(dtype).view(
                    (n,) + tuple(shape))
                leaf.index_copy_(1, idx, src.transpose(0, 1))
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    def _pack(self, snapshots, n):
        """JAX-form snapshots -> one host :class:`BlockPayload` in this
        pool's layout, each leaf checked against the layout."""
        lay = self.layout
        host = torch.zeros((n, lay.row_bytes), dtype=torch.uint8)
        for b in range(n):
            k_snap, v_snap = snapshots[b]
            if (len(k_snap) != self.num_layers
                    or len(v_snap) != self.num_layers):
                raise ValueError(
                    f"write_block: snapshot has {len(k_snap)}/"
                    f"{len(v_snap)} k/v layers, pool has {self.num_layers}")
            leaves = []
            for layer in tuple(k_snap) + tuple(v_snap):
                if len(layer) != lay.per_layer:
                    raise ValueError(
                        f"write_block: snapshot layer has {len(layer)} "
                        f"leaves, pool expects {lay.per_layer}")
                leaves.extend(layer)
            for leaf, (off, shape, dtype) in zip(leaves, lay.leaves):
                t = (leaf if isinstance(leaf, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(leaf)))
                if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                    raise ValueError(
                        f"write_block: snapshot leaf {tuple(t.shape)}/"
                        f"{t.dtype} does not match pool block layout "
                        f"{tuple(shape)}/{dtype}")
                nb = int(np.prod(shape)) * dtype.itemsize
                host[b, off:off + nb].view(dtype).view(shape).copy_(t)
        return BlockPayload(lay, [host])

    def read_block(self, block_id):
        """Host snapshot of ONE block (JAX's form): ``(k_layers,
        v_layers)``, each a tuple over layers of per-leaf tensors shaped
        like a block slice."""
        # a one-block row of its own, not pinned: no page-locked
        # allocation outside the engine's slab
        slab = PinnedSlab(self.layout.row_bytes, 1)
        return self.read_blocks([block_id], slab)[0]

    def write_block(self, block_id, snapshot):
        """Write one snapshot (from :meth:`read_block`, possibly of a
        different pool with the same :meth:`block_signature`) into block
        ``block_id``."""
        self.write_blocks([block_id], [snapshot])
