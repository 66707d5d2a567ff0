"""paddle_tpu_torch.compilecache — persistent compile cache for warm
restarts (counterpart of ``paddle_tpu/compilecache/``).

Three layers, as in the JAX package:

  * :class:`store.ArtifactStore` — atomic fsync'd writes, crc32
    verification, ``keep_last_k`` eviction, stale staging swept at init.
  * :class:`CompileCache` — the facade: content-addressed artifacts
    keyed on *(fn name, abstract signature, torch/CUDA/device/kernel-
    library environment)*, with every failure mode (corrupt artifact,
    truncated write, stale version, a blob that cannot be loaded)
    degrading to a miss, warned and counted — a broken cache can only
    ever cost a fresh compile, never correctness.
  * :class:`manifest.WarmupManifest` — the per-service program inventory
    a restarting ``serving.Engine`` replays BEFORE accepting traffic.

What an artifact holds differs from JAX's serialized executables (see
``aot``): for ``jit.to_static(cache=)`` the bytes of
``torch.compiler.save_cache_artifacts()`` (Inductor's cache entries: a
hit skips Inductor's code generation and Triton's compile, Dynamo still
traces); for ``EngineConfig(compile_cache=)`` each program's analysis
reports (the L3 summary and the L1 findings): a warm gated build runs
no analysis trace, and still captures every program, since a CUDA graph
cannot be serialized.

Observability: loads land in the compile event log as their own
``kind="aot-hit"`` (never a capture, never a retrace), and a pull-time
collector view exports ``paddle_tpu_compilecache_*`` series (hits /
misses / fallbacks / store errors / bytes / load seconds) per cache
directory.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
import weakref

from .aot import (
    AOTUnavailableError,
    abstractify,
    code_fingerprint,
    content_key,
    deserialize_compiled,
    env_fingerprint,
    serialize_compiled,
    signature_str,
)
from .manifest import WarmupManifest
from .store import ArtifactStore, CacheCorruptError

__all__ = [
    "CompileCache", "CacheMetrics", "ArtifactStore", "WarmupManifest",
    "CacheCorruptError", "AOTUnavailableError", "resolve",
    "content_key", "env_fingerprint", "signature_str", "abstractify",
    "code_fingerprint", "serialize_compiled", "deserialize_compiled",
]

_EXEC_BLOB = "exec"

# monotonic ids for metric labels (a re-created cache over the same dir
# must not alias a collected one's collector registration)
_cache_counter = itertools.count(1)


class CacheMetrics:
    """Host-side counters for one cache (plain attributes; the registry
    PULLS a snapshot at scrape time through the collector view)."""

    def __init__(self):
        self.hits = 0            # artifacts loaded from disk
        self.misses = 0          # absent entries (fresh compile follows)
        self.fallbacks = 0       # corrupt/stale/unloadable -> fresh compile
        self.store_errors = 0    # failed writes (degraded to warnings)
        self.bytes_read = 0
        self.bytes_written = 0
        self.load_seconds = 0.0  # cumulative verify + load time
        self.last_load_ms = 0.0

    def snapshot(self):
        return {
            "hits": self.hits,
            "misses": self.misses,
            "fallbacks": self.fallbacks,
            "store_errors": self.store_errors,
            "bytes_read": self.bytes_read,
            "bytes_written": self.bytes_written,
            "load_seconds": self.load_seconds,
            "last_load_ms": self.last_load_ms,
        }


# metrics attr -> (exported series, kind)
_CACHE_SERIES = {
    "hits": ("paddle_tpu_compilecache_hits_total", "counter"),
    "misses": ("paddle_tpu_compilecache_misses_total", "counter"),
    "fallbacks": ("paddle_tpu_compilecache_fallbacks_total", "counter"),
    "store_errors": (
        "paddle_tpu_compilecache_store_errors_total", "counter",
    ),
    "bytes_read": ("paddle_tpu_compilecache_bytes_read_total", "counter"),
    "bytes_written": (
        "paddle_tpu_compilecache_bytes_written_total", "counter",
    ),
    "load_seconds": (
        "paddle_tpu_compilecache_load_seconds_total", "counter",
    ),
    "last_load_ms": ("paddle_tpu_compilecache_last_load_ms", "gauge"),
}


def _register_view(cache):
    """Pull-time collector over one cache (weakref: a collected cache's
    view unregisters itself)."""
    from ..observability import MetricFamily, get_registry

    ref = weakref.ref(cache)
    label = {"cache": cache.root}

    def collect():
        cc = ref()
        if cc is None:
            return None
        m = cc.metrics
        return [
            MetricFamily(series, kind).add(getattr(m, attr), label)
            for attr, (series, kind) in _CACHE_SERIES.items()
        ]

    get_registry().register_collector(
        f"compilecache.{cache.cache_id}", collect
    )


def _warn(msg):
    sys.stderr.write(f"[compilecache] {msg}\n")


class CompileCache:
    """Disk-backed compile cache over one directory.

        cache = CompileCache(path)
        key = cache.key("to_static.forward", signature)
        got = cache.load_executable(key, name=..., signature=...)
        if got is None:
            ...                      # compile (Inductor fills its caches)
            cache.store_executable(key, name=..., signature=...)

    ``load_artifact``/``store_artifact`` carry any blobs (the serving
    engine's analysis reports); ``load_executable``/``store_executable``
    carry Inductor's cache artifacts under the ``exec`` blob.

    Failure semantics: a load returns ``None`` for ANY problem (absent,
    corrupt, truncated, stale version, a blob that cannot be loaded) —
    absent counts as a miss, damage counts as a fallback with a logged
    warning and a flight-recorder event; a store returns False on
    failure. Nothing in this class raises on the serving path.
    """

    def __init__(self, path, keep_last_k=None):
        self.root = os.path.abspath(path)
        self.store = ArtifactStore(self.root, keep_last_k=keep_last_k)
        self.env = env_fingerprint()
        self.metrics = CacheMetrics()
        self.cache_id = f"{next(_cache_counter)}"
        self._lock = threading.Lock()
        _register_view(self)

    def __repr__(self):
        return f"CompileCache({self.root!r})"

    # -- keys ----------------------------------------------------------------
    def key(self, name, signature):
        """Content address of one program under THIS environment."""
        return content_key(name, signature, self.env)

    def manifest(self, service_key):
        return WarmupManifest(self.root, service_key)

    # -- load ----------------------------------------------------------------
    def _fallback(self, key, name, reason):
        with self._lock:
            self.metrics.fallbacks += 1
        _warn(
            f"cache entry for {name!r} ({key}) unusable — falling back "
            f"to a fresh compile: {reason}"
        )
        try:
            from ..observability import flight

            flight.record(
                "compilecache", "fallback", key=key, fn=name,
                reason=reason,
            )
        except Exception:
            # analysis: allow(broad-except) telemetry is best-effort;
            # the fallback-to-compile path must never be blocked by it
            pass

    def _count_hit(self, nbytes, dt):
        with self._lock:
            self.metrics.hits += 1
            self.metrics.bytes_read += nbytes
            self.metrics.load_seconds += dt
            self.metrics.last_load_ms = dt * 1e3

    def fetch(self, key, name="", signature="", _count_hit=True):
        """Verified artifact read: ``(meta, blobs)`` or ``None``.
        Counts a miss when absent; counts a fallback (and warns) when
        present-but-unusable, including a recorded environment that
        disagrees with the running one (a copied or forged artifact
        must never be used under the wrong runtime)."""
        t0 = time.perf_counter()
        try:
            got = self.store.get(key)
        except CacheCorruptError as e:
            self._fallback(key, name, str(e))
            self.store.remove(key)  # unblock the re-store
            return None
        except Exception as e:
            # analysis: allow(broad-except) an injected cc.load fault or
            # a filesystem error IS the scenario this layer degrades:
            # a broken cache may only ever cost a fresh compile
            self._fallback(key, name, f"{type(e).__name__}: {e}")
            return None
        if got is None:
            with self._lock:
                self.metrics.misses += 1
            return None
        meta, blobs = got
        if meta.get("env") != self.env:
            self._fallback(
                key, name,
                f"environment mismatch (artifact: {meta.get('env')!r}, "
                f"running: {self.env!r})",
            )
            return None
        dt = time.perf_counter() - t0
        if _count_hit:
            self._count_hit(sum(len(b) for b in blobs.values()), dt)
        return meta, blobs

    def load_artifact(self, key, name="", signature="", finish=None):
        """Load one artifact: ``finish(meta, blobs)``'s value (``(meta,
        blobs)`` without it), or ``None`` on any miss or damage. An
        exception inside ``finish`` degrades like any other damaged
        artifact, so the hit count and the ``kind="aot-hit"`` event
        (neither a capture nor a retrace) are recorded only once the
        WHOLE artifact has been used."""
        t0 = time.perf_counter()
        got = self.fetch(key, name=name, signature=signature,
                         _count_hit=False)
        if got is None:
            return None
        meta, blobs = got
        result = got
        if finish is not None:
            try:
                result = finish(meta, blobs)
            except Exception as e:
                # analysis: allow(broad-except) any load error (pickle
                # damage, a refused blob, a bad sidecar) means "not
                # loadable here": degrade to a fresh compile
                self._fallback(
                    key, name,
                    f"artifact unusable: {type(e).__name__}: {e}",
                )
                self.store.remove(key)
                return None
        elapsed = time.perf_counter() - t0
        self._count_hit(sum(len(b) for b in blobs.values()), elapsed)
        from ..observability import jit_events

        jit_events.mark_aot_hit(
            name or "<compiled>", signature=signature, elapsed_s=elapsed,
        )
        return result

    def load_executable(self, key, name="", signature=""):
        """Load one artifact of Inductor cache entries into the local
        caches: the restored ``CacheInfo``, or ``None`` on any miss or
        damage (a blob ``load_cache_artifacts`` refuses is a counted,
        warned fallback, as in :meth:`load_artifact`)."""
        def load(meta, blobs):
            blob = blobs.get(_EXEC_BLOB)
            if blob is None:
                raise AOTUnavailableError("artifact holds no exec blob")
            return deserialize_compiled(blob)

        return self.load_artifact(key, name=name, signature=signature,
                                  finish=load)

    # -- store ---------------------------------------------------------------
    def store_artifact(self, key, blobs, name="", signature="",
                       extra_meta=None):
        """Publish one artifact of ``blobs`` ({name: bytes}); False on any
        failure (warned, counted — a cache that cannot write only loses
        warm restarts, it never takes down serving)."""
        try:
            meta = {
                "name": name, "signature": str(signature),
                "env": self.env, "created": time.time(),
            }
            if extra_meta:
                meta.update(extra_meta)
            written = self.store.put(key, blobs, meta)
        except Exception as e:
            # analysis: allow(broad-except) write failures (injected
            # cc.write faults, ENOSPC) degrade to a warning: the compile
            # already happened, serving runs
            with self._lock:
                self.metrics.store_errors += 1
            _warn(
                f"failed to persist {name!r} ({key}): "
                f"{type(e).__name__}: {e}"
            )
            return False
        with self._lock:
            self.metrics.bytes_written += written
        return True

    def store_executable(self, key, name="", signature=""):
        """Serialize this process's Inductor cache artifacts and publish
        them under ``key``; False on any failure (warned, counted)."""
        try:
            blobs = {_EXEC_BLOB: serialize_compiled()}
        except Exception as e:
            # analysis: allow(broad-except) nothing to serialize degrades
            # like a failed write: the compile already happened
            with self._lock:
                self.metrics.store_errors += 1
            _warn(f"failed to serialize {name!r} ({key}): "
                  f"{type(e).__name__}: {e}")
            return False
        return self.store_artifact(key, blobs, name=name,
                                   signature=signature)


# path -> CompileCache memo: an engine restart inside one process (the
# fleet supervisor path) reuses the instance, its metrics, and its
# collector view instead of stacking registrations per rebuild
_resolved: dict = {}
_resolve_lock = threading.Lock()


def resolve(obj, keep_last_k=None):
    """Coerce a config value into a CompileCache: None passes through,
    a CompileCache is returned as-is, a path string is memoized per
    absolute path. An explicit ``keep_last_k`` is applied to an
    already-memoized cache too (the latest bound wins)."""
    if obj is None or isinstance(obj, CompileCache):
        return obj
    path = os.path.abspath(os.fspath(obj))
    with _resolve_lock:
        cache = _resolved.get(path)
        if cache is None:
            cache = _resolved[path] = CompileCache(
                path, keep_last_k=keep_last_k
            )
        elif keep_last_k is not None:
            cache.store.keep_last_k = keep_last_k
        return cache
