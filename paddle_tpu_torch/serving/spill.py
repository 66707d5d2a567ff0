"""Hierarchical KV spill tier: host-memory block swap under the paged pool.

Counterpart of ``paddle_tpu/serving/spill.py`` (the port's own copy: the
same tier, classes, counters, peer registry, fault sites and collector
view). Without it every memory-pressure event throws work away: an
LRU-evicted prefix-cache chain dies, a preempted request recomputes its
whole KV, and a pool too large for the card fails the build.
:class:`HostSpillTier` adds a host tier under the device pool:

  * **Prefix-chain spill** — ``PrefixCache`` eviction demotes full chain
    blocks here (keyed by chain digest) instead of freeing their bytes; a
    later chain match restores them into fresh pool blocks, byte-identical
    to the never-evicted path.
  * **Restore-instead-of-recompute preemption** — ``Engine._preempt`` and
    ``Engine.release`` snapshot a victim's cached blocks here as ONE
    handle; re-admission writes them back and skips the re-prefill. The
    handle key is journaled on the re-ADMIT record, so a crash replay can
    re-anchor it against the disk tier.
  * **Disk third tier** — ``spill_dir=`` demotes host-LRU victims to
    ``.npz`` files (temp name then ``os.replace``, content-keyed names,
    the pool's block signature in ``meta``) and serves misses from disk,
    also to a fresh process pointed at the same directory.

Payloads are ``kv_cache.BlockPayload`` objects (one host row per block,
from ``KVPool.read_blocks``) or lists of JAX-form per-block snapshots
(``(k_layers, v_layers)``, per layer a tuple of leaves: ``(pages,)`` or
``(pages, scales)``), tensors or numpy arrays. On the card the engine's
payload rows live in one :class:`PinnedSlab` allocated at engine build:
every spilled block of one signature has the same size, so fixed rows
allocated once replace a ``cudaHostAlloc`` per spill (one from any thread
invalidates a CUDA graph capture in progress, ``serving/programs.py``).
The tier owns a payload it accepted and releases its slab rows when it
drops it (host LRU eviction, demotion to disk, ``discard``, ``clear``);
``get(pop=True)`` hands the payload to the caller, who releases it after
the restore.

Disk format (the port's own): the JAX layout — one array per leaf,
``meta`` a JSON of the signature, class, token count and per-block leaf
counts — plus ``meta["dtypes"]``, each leaf's dtype name. numpy has no
bfloat16 without ``ml_dtypes``, which the port does not use, so a
bfloat16 leaf is stored as its raw 16-bit words and viewed back as
bfloat16 on read. Leaves read from disk come back as CPU tensors.

Degradation contract: the fault sites ``kv.spill`` and ``kv.restore``
fire at the head of :meth:`HostSpillTier.put` / :meth:`HostSpillTier.get`;
an injected failure warns ONCE, counts, and returns False/None — the
caller falls back to free-and-recompute, never crashes, never leaks a
block. Unlike JAX's, a ``torch.AcceleratorError`` (a CUDA error, sticky
for the process) is re-raised, never degraded.

Thread safety: the tier is mutated by the scheduler thread and read by
the metrics scrape thread, so every entry-map and counter access holds
``self._lock``.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import warnings
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..resilience import faults

__all__ = [
    "HostSpillTier", "PinnedSlab", "drop_handle", "is_resource_exhausted",
    "payload_nbytes", "register_spill_view",
]

# spill classes: "prefix" entries are chain-digest-keyed single blocks;
# "request" entries are whole-request handles (every cached block of one
# preempted or released request)
_CLASSES = ("prefix", "request")

# substrings that identify an out-of-memory failure: the JAX/XLA
# flavors, and torch's ("CUDA out of memory")
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OUT_OF_MEMORY")

# a CUDA error is sticky for the process: never degraded to recompute
_DEVICE_FAULTS = (torch.AcceleratorError,)

# live tiers in this process, for same-host handle exchange: a fleet
# migration releases on one engine and resumes on another, and when both
# share the process the survivor may restore a handle the source tier
# holds. WeakSet: a dead engine's tier must not be pinned by the registry.
_TIERS: "weakref.WeakSet" = weakref.WeakSet()

_BF16_WORDS = "bfloat16"    # a leaf stored as raw 16-bit words


def is_resource_exhausted(exc):
    """True when ``exc`` is a device allocation failure
    (``torch.OutOfMemoryError``, "CUDA out of memory", or the JAX/XLA
    RESOURCE_EXHAUSTED flavors): the trigger for the memory-pressure
    ladder (reclaim -> spill -> shed) instead of a crash."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKERS)


def payload_nbytes(payload):
    """Host bytes of one spill payload: a ``BlockPayload``'s ``nbytes``,
    or the leaves' bytes of a list of per-block snapshots."""
    nbytes = getattr(payload, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    total = 0
    for snap in payload:
        for side in snap:                 # (k_layers, v_layers)
            for layer in side:            # per-layer leaf tuple
                for leaf in layer:
                    total += int(leaf.nbytes)
    return total


def drop_handle(req, tier=None):
    """Give up ``req``'s spill handle: discard its key from the tier that
    took it (``req.spill_tier``) and from ``tier`` (the disk level a
    journal replay re-anchored it on), and clear the request's handle
    fields. A handle that will not be restored then holds no slab row, no
    budget byte and no reference to a dropped engine's slab. Idempotent."""
    key, holder = req.spill_key, req.spill_tier
    req.spill_key = req.spill_tier = None
    req.spill_tokens = 0
    if key is None:
        return
    for t in {holder, tier} - {None}:
        t.discard(key)


def _release(payload):
    rel = getattr(payload, "release", None)
    if rel is not None:
        rel()


class PinnedSlab:
    """``num_rows`` fixed host rows of ``row_bytes`` each (pinned when
    ``pin``), allocated once: where ``KVPool.read_blocks`` puts a spilled
    handle's blocks. ``alloc(n)`` takes the n lowest free rows (None when
    fewer are free), ``runs`` groups rows into consecutive runs (one copy
    each), ``free`` returns them."""

    def __init__(self, row_bytes, num_rows, pin=False):
        self.row_bytes = int(row_bytes)
        self.num_rows = int(num_rows)
        self.rows = torch.empty((self.num_rows, self.row_bytes),
                                dtype=torch.uint8, pin_memory=bool(pin))
        self._free = list(range(self.num_rows))    # sorted ascending
        self._lock = threading.Lock()

    @property
    def num_free(self):
        with self._lock:
            return len(self._free)

    def alloc(self, n):
        with self._lock:
            if n > len(self._free):
                return None
            rows, self._free = self._free[:n], self._free[n:]
            return rows

    def free(self, rows):
        with self._lock:
            for r in rows:
                bisect.insort(self._free, r)

    @staticmethod
    def runs(rows):
        """``(start, length)`` of each run of consecutive rows, in order."""
        out = []
        for r in rows:
            if out and out[-1][0] + out[-1][1] == r:
                out[-1][1] += 1
            else:
                out.append([r, 1])
        return [tuple(r) for r in out]


class _SpillEntry:
    __slots__ = ("key", "cls", "payload", "nbytes", "signature",
                 "num_tokens")

    def __init__(self, key, cls, payload, nbytes, signature, num_tokens):
        self.key = key
        self.cls = cls
        self.payload = payload        # None when demoted to disk only
        self.nbytes = nbytes
        self.signature = signature
        self.num_tokens = num_tokens


class HostSpillTier:
    """Bounded host store of spilled KV blocks, its own LRU.

    ``capacity_bytes`` bounds the payload bytes held at once; exceeding
    it evicts oldest entries first — to the ``spill_dir`` disk tier when
    one is configured, otherwise they are dropped (the caller's recompute
    path still exists). Keys are plain strings (``"prefix:<digest-hex>"``
    / ``"req:<rid>:<seq>"``) so they ride journal records unchanged;
    every entry carries the pool's ``block_signature()`` and a restore
    against a different layout is a miss, not a corruption. ``slab`` is
    the engine's :class:`PinnedSlab`, the rows ``KVPool.read_blocks``
    fills for this tier (None for a tier fed JAX-form snapshots only).
    """

    def __init__(self, capacity_bytes, spill_dir=None, engine_id="0",
                 slab=None):
        capacity_bytes = int(capacity_bytes)
        if capacity_bytes < 1:
            raise ValueError(
                f"host_spill_bytes must be >= 1, got {capacity_bytes}"
            )
        self.capacity_bytes = capacity_bytes
        self.spill_dir = str(spill_dir) if spill_dir is not None else None
        if self.spill_dir is not None:
            os.makedirs(self.spill_dir, exist_ok=True)
        self.engine_id = str(engine_id)
        self.slab = slab
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> _SpillEntry
        self._host_bytes = 0
        # counters (read by the scrape thread through stats())
        self.spilled_blocks = dict.fromkeys(_CLASSES, 0)
        self.spilled_bytes = dict.fromkeys(_CLASSES, 0)
        self.restored_blocks = dict.fromkeys(_CLASSES, 0)
        self.restored_bytes = dict.fromkeys(_CLASSES, 0)
        self.restore_hits = 0
        self.restore_misses = 0
        self.spill_errors = 0
        self.restore_errors = 0
        self.host_evictions = 0
        self.disk_writes = 0
        self.disk_reads = 0
        self.disk_errors = 0
        self.restore_seconds_total = 0.0
        self.restores = 0
        self._spill_warned = False
        self._restore_warned = False
        _TIERS.add(self)

    # -- core API ------------------------------------------------------------
    def put(self, key, payload, signature, num_tokens=0, cls="prefix"):
        """Admit one spill payload under ``key``; the tier owns it from
        here. Returns True when the bytes are safely in the host (or
        disk) tier — only then may the caller treat the device blocks as
        restorable. False means the old destructive path applies
        (injected ``kv.spill`` fault, a payload larger than the whole
        budget with no disk tier, an unwritable disk tier): warn-once and
        counted, never raised; the payload is released."""
        nbytes = payload_nbytes(payload)
        try:
            faults.fire("kv.spill", key=key, cls=cls, nbytes=nbytes)
        except _DEVICE_FAULTS:
            _release(payload)
            raise
        except Exception as e:
            # the degradation contract: an injected spill failure falls
            # back to the free-and-recompute path
            _release(payload)
            self._degrade("spill", e)
            return False
        with self._lock:
            if nbytes > self.capacity_bytes and self.spill_dir is None:
                self.spill_errors += 1
                _release(payload)
                return False
            old = self._entries.pop(key, None)
            if old is not None and old.payload is not None:
                self._host_bytes -= old.nbytes
                _release(old.payload)
            entry = _SpillEntry(
                key, cls, payload, nbytes, signature, int(num_tokens)
            )
            if nbytes > self.capacity_bytes:
                # bigger than the whole host budget: straight to disk
                written = self._disk_write(entry)
                _release(payload)
                if not written:
                    self.spill_errors += 1
                    return False
                entry.payload = None
            else:
                self._host_bytes += nbytes
            self._entries[key] = entry
            self.spilled_blocks[cls] = (
                self.spilled_blocks.get(cls, 0) + len(payload)
            )
            self.spilled_bytes[cls] = (
                self.spilled_bytes.get(cls, 0) + nbytes
            )
            self._enforce_budget()
            return True

    def get(self, key, signature, pop=False):
        """Fetch a payload for restore. Returns the payload or None
        (miss / signature mismatch / injected ``kv.restore`` fault /
        unreadable disk entry) — None means the caller recomputes. Checks
        this tier (host then disk), then the other live tiers in the
        process (same-host migration hands a handle from the source
        engine's tier to the survivor's). With ``pop`` the entry leaves
        the tier and the caller releases the payload after use; without
        it the payload stays the tier's, valid until the tier drops the
        entry (its slab rows are then reused)."""
        try:
            faults.fire("kv.restore", key=key)
        except _DEVICE_FAULTS:
            raise
        except Exception as e:
            # the degradation contract: an injected restore failure falls
            # back to the recompute path
            self._degrade("restore", e)
            return None
        payload = self._get_local(key, signature, pop)
        if payload is None:
            for tier in list(_TIERS):
                if tier is self:
                    continue
                payload = tier._get_local(key, signature, pop)
                if payload is not None:
                    break
        with self._lock:
            if payload is None:
                self.restore_misses += 1
            else:
                self.restore_hits += 1
        return payload

    def has(self, key, signature):
        """Cheap restorability peek (no fault fire, no hit/miss
        accounting): does any live tier — or this tier's disk — hold
        ``key`` under a matching pool signature?"""
        if self._has_local(key, signature):
            return True
        return any(
            tier is not self and tier._has_local(key, signature)
            for tier in list(_TIERS)
        )

    def discard(self, key):
        """Drop ``key`` if held (host and disk); idempotent."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None and e.payload is not None:
                self._host_bytes -= e.nbytes
                _release(e.payload)
        self._disk_remove(key)

    def note_restored(self, cls, payload, seconds):
        """Book a COMPLETED restore (payload fetched AND written back into
        the pool) — restored blocks/bytes only count once the device write
        succeeded, so the counters never overstate."""
        nbytes = payload_nbytes(payload)
        with self._lock:
            self.restored_blocks[cls] = (
                self.restored_blocks.get(cls, 0) + len(payload)
            )
            self.restored_bytes[cls] = (
                self.restored_bytes.get(cls, 0) + nbytes
            )
            self.restore_seconds_total += float(seconds)
            self.restores += 1

    def note_restore_failure(self, cls):
        """A fetched payload failed its device write: counted here so
        ``restore_errors`` covers both halves of the path."""
        with self._lock:
            self.restore_errors += 1

    def note_spill_failure(self, cls):
        """A device-side block read failed before ``put`` — counted so the
        spill error total covers the whole demotion path."""
        with self._lock:
            self.spill_errors += 1

    # -- internals -----------------------------------------------------------
    def _get_local(self, key, signature, pop):
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.signature != signature:
                return None
            if e is not None and e.payload is not None:
                payload = e.payload
                if pop:
                    self._entries.pop(key)
                    self._host_bytes -= e.nbytes
                    self._disk_remove(key)
                else:
                    self._entries.move_to_end(key)
                return payload
        # disk tier (entry demoted, or written by a dead incarnation)
        payload = self._disk_read(key, signature)
        if payload is not None and pop:
            self._disk_remove(key)
            with self._lock:
                e = self._entries.pop(key, None)
                if e is not None and e.payload is not None:
                    self._host_bytes -= e.nbytes
                    _release(e.payload)
        return payload

    def _has_local(self, key, signature):
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                return e.signature == signature
        if self.spill_dir is None:
            return False
        return os.path.exists(self._disk_path(key))

    def _enforce_budget(self):
        """Caller holds the lock. Oldest-first host eviction down to
        ``capacity_bytes``; victims demote to disk when configured."""
        while self._host_bytes > self.capacity_bytes and self._entries:
            victim = None
            for key, e in self._entries.items():   # oldest first
                if e.payload is not None:
                    victim = key
                    break
            if victim is None:
                break
            e = self._entries[victim]
            payload = e.payload
            if self.spill_dir is not None and self._disk_write(e):
                e.payload = None           # demoted, key stays findable
                self._entries.move_to_end(victim)
            else:
                self._entries.pop(victim)
            _release(payload)
            self._host_bytes -= e.nbytes
            self.host_evictions += 1

    def _degrade(self, stage, exc):
        with self._lock:
            if stage == "spill":
                self.spill_errors += 1
                warned, self._spill_warned = self._spill_warned, True
            else:
                self.restore_errors += 1
                warned, self._restore_warned = self._restore_warned, True
        if not warned:
            warnings.warn(
                f"[spill] kv.{stage} failed "
                f"({type(exc).__name__}: {exc}); degrading to the "
                "recompute path (warned once, counted in "
                f"{stage}_errors)",
                stacklevel=3,
            )

    # -- disk third tier -----------------------------------------------------
    def _disk_path(self, key):
        name = hashlib.sha256(key.encode()).hexdigest()[:32]
        return os.path.join(self.spill_dir, f"kv-{name}.npz")

    def _disk_write(self, entry):
        """Caller holds the lock (rare path: demotion/oversize only).
        Written to a temp name and renamed into place — a SIGKILL
        mid-write leaves no half-entry under the real key."""
        if self.spill_dir is None or entry.payload is None:
            return False
        path = self._disk_path(entry.key)
        arrays, dtypes = {}, []
        structure = []                 # per-block (k, v) leaf counts
        i = 0
        for snap in entry.payload:
            sides = []
            for side in snap:
                layers = []
                for layer in side:
                    layers.append(len(layer))
                    for leaf in layer:
                        arr, name = _leaf_to_numpy(leaf)
                        arrays[f"a{i}"] = arr
                        dtypes.append(name)
                        i += 1
                sides.append(layers)
            structure.append(sides)
        meta = json.dumps({
            "signature": entry.signature, "cls": entry.cls,
            "num_tokens": entry.num_tokens, "structure": structure,
            "dtypes": dtypes,
        })
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, meta=np.frombuffer(
                    meta.encode(), dtype=np.uint8
                ), **arrays)
            os.replace(tmp, path)
            self.disk_writes += 1
            return True
        except (OSError, ValueError):
            # unwritable disk tier: the entry dies as it did before the
            # tier existed
            self.disk_errors += 1
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    def _disk_read(self, key, signature):
        if self.spill_dir is None:
            return None
        path = self._disk_path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                if meta["signature"] != signature:
                    return None
                dtypes = meta["dtypes"]
                payload = []
                i = 0
                for sides in meta["structure"]:
                    snap = []
                    for layers in sides:
                        side = []
                        for n in layers:
                            side.append(tuple(
                                _leaf_from_numpy(z[f"a{i + j}"],
                                                 dtypes[i + j])
                                for j in range(n)
                            ))
                            i += n
                        snap.append(tuple(side))
                    payload.append(tuple(snap))
            with self._lock:
                self.disk_reads += 1
            return payload
        except (OSError, ValueError, KeyError, IndexError, TypeError):
            # a torn or alien file is a miss (recompute path), never a
            # crash
            with self._lock:
                self.disk_errors += 1
            return None

    def _disk_remove(self, key):
        if self.spill_dir is None:
            return
        try:
            os.remove(self._disk_path(key))
        except OSError:
            pass

    # -- introspection -------------------------------------------------------
    def disk_tokens(self, key):
        """Token count recorded with a disk entry (crash re-anchor uses the
        journaled count; this is the cross-check)."""
        if self.spill_dir is None:
            return None
        path = self._disk_path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                return json.loads(
                    bytes(z["meta"]).decode()
                ).get("num_tokens")
        except (OSError, ValueError, KeyError):
            return None

    def stats(self):
        """Snapshot for ``Engine.health()`` / the collector view (one lock
        hold; every value is a plain number)."""
        with self._lock:
            hits, misses = self.restore_hits, self.restore_misses
            lookups = hits + misses
            return {
                "host_bytes": self._host_bytes,
                "host_capacity_bytes": self.capacity_bytes,
                "host_entries": sum(
                    1 for e in self._entries.values()
                    if e.payload is not None
                ),
                "disk_entries": sum(
                    1 for e in self._entries.values()
                    if e.payload is None
                ),
                "spilled_blocks": dict(self.spilled_blocks),
                "spilled_bytes": dict(self.spilled_bytes),
                "restored_blocks": dict(self.restored_blocks),
                "restored_bytes": dict(self.restored_bytes),
                "restore_hits": hits,
                "restore_misses": misses,
                "restore_hit_rate": (
                    hits / lookups if lookups else None
                ),
                "restore_ms_mean": (
                    1e3 * self.restore_seconds_total / self.restores
                    if self.restores else None
                ),
                "restores": self.restores,
                "restore_seconds_total": self.restore_seconds_total,
                "spill_errors": self.spill_errors,
                "restore_errors": self.restore_errors,
                "host_evictions": self.host_evictions,
                "disk_writes": self.disk_writes,
                "disk_reads": self.disk_reads,
                "disk_errors": self.disk_errors,
            }

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def clear(self):
        with self._lock:
            for e in self._entries.values():
                if e.payload is not None:
                    _release(e.payload)
            self._entries.clear()
            self._host_bytes = 0


def _leaf_to_numpy(leaf):
    """One payload leaf as a numpy array and its dtype name (a bfloat16
    tensor as its raw 16-bit words)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16_WORDS
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_from_numpy(arr, name):
    """Inverse of :func:`_leaf_to_numpy`: a CPU tensor."""
    t = torch.from_numpy(np.array(arr))
    if name == _BF16_WORDS:
        return t.view(torch.bfloat16)
    return t


def register_spill_view(tier, engine_id, registry=None):
    """Pull-time collector over one spill tier — the
    ``paddle_tpu_serving_spill_*`` family. Weakref: a collected engine's
    tier unregisters itself at the next scrape, mirroring the
    EngineMetrics/StepStats views."""
    from ..observability import MetricFamily, get_registry

    ref = weakref.ref(tier)
    label = {"engine": str(engine_id)}

    def collect():
        t = ref()
        if t is None:
            return None
        s = t.stats()
        fams = [
            MetricFamily(
                "paddle_tpu_serving_spill_host_bytes", "gauge",
            ).add(s["host_bytes"], label),
            MetricFamily(
                "paddle_tpu_serving_spill_host_capacity_bytes", "gauge",
            ).add(s["host_capacity_bytes"], label),
            MetricFamily(
                "paddle_tpu_serving_spill_host_entries", "gauge",
            ).add(s["host_entries"], label),
        ]
        spilled_b = MetricFamily(
            "paddle_tpu_serving_spill_spilled_blocks_total", "counter",
        )
        spilled_y = MetricFamily(
            "paddle_tpu_serving_spill_spilled_bytes_total", "counter",
        )
        restored_b = MetricFamily(
            "paddle_tpu_serving_spill_restored_blocks_total", "counter",
        )
        restored_y = MetricFamily(
            "paddle_tpu_serving_spill_restored_bytes_total", "counter",
        )
        for cls in _CLASSES:
            cl = {**label, "class": cls}
            spilled_b.add(s["spilled_blocks"].get(cls, 0), cl)
            spilled_y.add(s["spilled_bytes"].get(cls, 0), cl)
            restored_b.add(s["restored_blocks"].get(cls, 0), cl)
            restored_y.add(s["restored_bytes"].get(cls, 0), cl)
        fams += [spilled_b, spilled_y, restored_b, restored_y]
        if s["restore_hit_rate"] is not None:
            fams.append(MetricFamily(
                "paddle_tpu_serving_spill_restore_hit_rate", "gauge",
            ).add(s["restore_hit_rate"], label))
        errors = MetricFamily(
            "paddle_tpu_serving_spill_errors_total", "counter",
        )
        errors.add(s["spill_errors"], {**label, "stage": "spill"})
        errors.add(s["restore_errors"], {**label, "stage": "restore"})
        fams.append(errors)
        return fams

    (registry or get_registry()).register_collector(
        f"serving.spill.{engine_id}", collect
    )
