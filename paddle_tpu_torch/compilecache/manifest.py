"""Warmup manifests: the program inventory an engine replays at restart.

Counterpart of ``paddle_tpu/compilecache/manifest.py``, copied (it is
pure Python). A serving ``Engine`` builds a closed set of programs: the
decode step (greedy and sampling), one prefill per length bucket, and,
as enabled, the continuation prefills, the copy-on-write copy and the
speculative verify step. The manifest is that set written down: one
JSON file per *service* (a stable hash of the adapter's weight tree,
the engine config and the kernel libraries) listing every ``(fn,
signature)`` pair, with the store key of its artifact (in the port, the
program's analysis reports: a CUDA graph cannot be serialized). A
restarting engine loads the manifest FIRST, reads every entry from the
artifact store and captures every listed program before it accepts
traffic.

Lifecycle: entries are appended when a program is first analysed or
built, and the file is rewritten atomically each time; replay tolerates
missing or corrupt artifacts (those entries are analysed afresh and
re-stored). The manifest never stores artifacts itself — only keys — so
a stale manifest is at worst a set of misses.
"""
from __future__ import annotations

import json
import os
import uuid

__all__ = ["WarmupManifest"]

_MANIFESTS_DIR = "manifests"
_VERSION = 1


class WarmupManifest:
    """The ordered set of programs one service warms at startup."""

    def __init__(self, root, service_key):
        self.root = os.path.abspath(root)
        self.service_key = str(service_key)
        self._dir = os.path.join(self.root, _MANIFESTS_DIR)
        self.path = os.path.join(
            self._dir, f"{self.service_key}.json"
        )
        self.entries: list = []

    def load(self):
        """Read entries from disk (missing/unreadable -> empty: a torn
        manifest degrades to a cold start, never an error)."""
        try:
            with open(self.path) as f:
                payload = json.load(f)
            entries = payload.get("entries", [])
            self.entries = [e for e in entries if isinstance(e, dict)]
        except (OSError, ValueError):
            self.entries = []
        return self.entries

    def add(self, name, signature, store_key, **extra):
        """Record one traced program (idempotent on ``store_key``)."""
        for e in self.entries:
            if e.get("store_key") == store_key:
                return e
        entry = {
            "name": name, "signature": signature,
            "store_key": store_key, **extra,
        }
        self.entries.append(entry)
        return entry

    def save(self):
        """Atomic rewrite (temp file + rename, fsync'd) — a crash never
        leaves a half-written manifest."""
        os.makedirs(self._dir, exist_ok=True)
        tmp = os.path.join(
            self._dir, f".tmp-{uuid.uuid4().hex[:8]}"
        )
        with open(tmp, "w") as f:
            json.dump(
                {"version": _VERSION, "service": self.service_key,
                 "entries": self.entries}, f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
