"""Content-addressed disk artifact store for compiled-program blobs.

Counterpart of ``paddle_tpu/compilecache/store.py``, copied (it is pure
Python). The persistence layer under ``compilecache.CompileCache``: one
artifact per cache key, where a key is the content address of *(fn
name, abstract signature, torch/CUDA/kernel-library environment)* — see
``aot.content_key``.
The write discipline is checkpoint-v2's (``distributed/checkpoint.py``):
every ``put`` lands in a temp dir, every blob is fsync'd, a crc32 per
blob is recorded in the metadata, and the artifact becomes visible only
through one atomic rename — a torn write can never be read as a valid
artifact. ``get`` re-verifies every checksum before handing bytes back
and raises :class:`CacheCorruptError` on any damage, so the cache layer
above can degrade to a fresh compile instead of loading garbage.

Layout under ``root``::

    objects/<key>/meta.json     env fingerprint, name/signature, crc32s
    objects/<key>/<blob>.bin    opaque payloads (Inductor cache artifacts,
                                analysis reports)
    manifests/<service>.json    warmup manifests (see manifest.py)

Fault sites: ``cc.write`` fires once per
artifact publish, ``cc.load`` once per artifact read — tests schedule
truncated writes and unreadable loads there and assert both degrade to
a fresh compile, never a crash.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid
import zlib

from ..distributed.checkpoint import _fsync_dir
from ..resilience import faults

__all__ = ["ArtifactStore", "CacheCorruptError"]

_META_FILE = "meta.json"
_OBJECTS_DIR = "objects"

# crash-orphaned .tmp-*/.old-* staging dirs older than this are swept
# at store construction (young ones may belong to a live writer in
# another process)
_STALE_STAGING_S = 3600.0


class CacheCorruptError(RuntimeError):
    """An artifact exists on disk but fails verification (torn write,
    bit rot, checksum mismatch). Callers fall back to compiling."""


class ArtifactStore:
    """Atomic, verified blob storage keyed by content address.

    ``keep_last_k`` bounds the number of retained artifacts: each
    publish evicts the least-recently-touched artifacts beyond the
    budget (``get`` bumps an artifact's mtime, so warm-path entries
    survive while abandoned signatures age out).
    """

    def __init__(self, root, keep_last_k=None):
        if keep_last_k is not None and keep_last_k < 1:
            raise ValueError(
                f"keep_last_k must be >= 1 or None (keep all), got "
                f"{keep_last_k}"
            )
        self.root = os.path.abspath(root)
        self.keep_last_k = keep_last_k
        self._objects = os.path.join(self.root, _OBJECTS_DIR)
        os.makedirs(self._objects, exist_ok=True)
        self._sweep_stale_staging()

    def _sweep_stale_staging(self):
        """Remove crash-orphaned staging dirs (a publish that died
        between its renames leaves a ``.old-*`` aside; one that died
        mid-write leaves a ``.tmp-*``). Age-gated so a concurrent
        writer's live staging dir is never swept from under it."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        cutoff = time.time() - _STALE_STAGING_S
        for n in names:
            if not n.startswith((".tmp-", ".old-")):
                continue
            p = os.path.join(self.root, n)
            try:
                if os.path.getmtime(p) < cutoff:
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                continue

    def _dir(self, key):
        if not key or os.sep in key or key.startswith("."):
            raise ValueError(f"invalid artifact key {key!r}")
        return os.path.join(self._objects, key)

    # -- write ---------------------------------------------------------------
    def put(self, key, blobs, meta):
        """Publish one artifact atomically; returns bytes written.

        ``blobs``: {name: bytes}; ``meta``: JSON-able dict (the store
        adds ``checksums``). Raises on I/O failure — the cache layer
        above catches and degrades, the store itself never half-writes:
        until the rename lands, ``get`` sees the previous state.
        """
        final = self._dir(key)
        tmp = os.path.join(self.root, f".tmp-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        written = 0
        try:
            faults.fire("cc.write", key=key, path=self.root)
            checksums = {}
            for name, data in blobs.items():
                if not isinstance(data, (bytes, bytearray)):
                    raise TypeError(
                        f"blob {name!r} must be bytes, got "
                        f"{type(data).__name__}"
                    )
                checksums[name] = zlib.crc32(data) & 0xFFFFFFFF
                p = os.path.join(tmp, f"{name}.bin")
                with open(p, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                written += len(data)
            payload = dict(meta)
            payload["checksums"] = checksums
            with open(os.path.join(tmp, _META_FILE), "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            # replace-on-rewrite: an existing artifact is renamed ASIDE
            # (not rmtree'd in place) so readers never see the key
            # absent and a crash between the renames leaves the old
            # artifact recoverable on disk, not lost
            old = None
            if os.path.isdir(final):
                old = os.path.join(self.root, f".old-{uuid.uuid4().hex[:8]}")
                try:
                    os.rename(final, old)
                except FileNotFoundError:
                    old = None  # racing writer already superseded it
            try:
                os.rename(tmp, final)
            except OSError:
                if not os.path.isdir(final):
                    if old is not None:
                        # a failed publish must not LOSE the live entry:
                        # put the previous artifact back before raising
                        try:
                            os.rename(old, final)
                            old = None
                        except OSError:
                            pass
                    raise
                # a concurrent publish of this content-addressed key won
                # the rename — identical bytes already landed: success
                shutil.rmtree(tmp, ignore_errors=True)
            _fsync_dir(self._objects)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._evict(protect=key)
        return written

    def _evict(self, protect=None):
        if self.keep_last_k is None:
            return
        entries = []
        for name in self.keys():
            try:
                entries.append(
                    (os.path.getmtime(self._dir(name)), name)
                )
            except OSError:
                continue  # racing eviction/removal: already gone
        entries.sort(reverse=True)  # newest first
        for _, name in entries[self.keep_last_k:]:
            if name != protect:
                shutil.rmtree(self._dir(name), ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def get(self, key):
        """Verified read: ``(meta, blobs)`` or ``None`` when absent.
        Raises :class:`CacheCorruptError` when the artifact exists but
        any blob fails its checksum or the metadata is unreadable."""
        d = self._dir(key)
        if not os.path.isdir(d):
            return None
        faults.fire("cc.load", key=key, path=self.root)
        try:
            with open(os.path.join(d, _META_FILE)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CacheCorruptError(
                f"{key}: unreadable artifact metadata ({e})"
            ) from e
        checksums = meta.get("checksums") or {}
        blobs = {}
        for name, want in checksums.items():
            p = os.path.join(d, f"{name}.bin")
            try:
                with open(p, "rb") as f:
                    data = f.read()
            except OSError as e:
                raise CacheCorruptError(
                    f"{key}: blob {name!r} unreadable ({e})"
                ) from e
            if (zlib.crc32(data) & 0xFFFFFFFF) != want:
                raise CacheCorruptError(
                    f"{key}: checksum mismatch for blob {name!r}"
                )
            blobs[name] = data
        try:
            # LRU touch for keep_last_k eviction ordering
            os.utime(d)
        except OSError:
            pass
        return meta, blobs

    def get_meta(self, key):
        """Metadata-only read: the artifact's meta dict, or ``None``
        when the artifact is absent or its metadata is unreadable. No
        blob I/O, no checksum pass, no LRU touch — the cheap path for
        callers that only need sidecar metadata (e.g. a warm-restarting
        engine reading a stored analysis summary without deserializing
        the executable)."""
        d = self._dir(key)
        try:
            with open(os.path.join(d, _META_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def contains(self, key):
        return os.path.isdir(self._dir(key))

    def remove(self, key):
        """Drop one artifact (e.g. after it failed verification, so the
        next publish is not blocked by a known-bad entry)."""
        shutil.rmtree(self._dir(key), ignore_errors=True)

    def keys(self):
        try:
            return [
                n for n in os.listdir(self._objects)
                if os.path.isdir(os.path.join(self._objects, n))
            ]
        except OSError:
            return []
