"""Compile-cache CLI: pre-populate a fleet's cache ahead of deploy.

    python -m paddle_tpu_torch.compilecache warm --manifest <path> \
        [--cache <dir>] [--builder pkg.mod:callable]

Counterpart of ``python -m paddle_tpu.compilecache``. ``warm`` reads a
warmup manifest (the per-service program inventory a ``serving.Engine``
maintains) and verifies that every listed program's artifact is present
in the artifact store. With ``--builder`` it first BUILDS what is
missing: the builder is imported and called with the cache directory,
and is expected to construct the service's engines against it —
``EngineConfig(compile_cache=<dir>)`` analyses and persists the full
program set as a side effect of the build. Run it on a machine with the
deploy environment (same torch, CUDA, card and kernel sources — the
content keys fold the environment fingerprint, so artifacts built
elsewhere are clean misses).

Exit codes: 0 every manifest entry present; 2 unreadable manifest;
3 entries still missing (no builder given, or the builder did not
produce them).
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import sys

from .store import ArtifactStore

__all__ = ["main"]


def _load_manifest(path):
    with open(path) as f:
        payload = json.load(f)
    entries = payload.get("entries", [])
    # an entry without a store key (hand-edited / foreign manifest) is
    # unverifiable — drop it rather than crash the deploy pipeline
    return [
        e for e in entries
        if isinstance(e, dict) and e.get("store_key")
    ]


def _call_builder(spec, cache_root):
    mod_name, _, attr = spec.partition(":")
    if not mod_name or not attr:
        raise ValueError(
            f"--builder must be 'module:callable', got {spec!r}"
        )
    builder = getattr(importlib.import_module(mod_name), attr)
    if inspect.signature(builder).parameters:
        return builder(cache_root)
    return builder()


def _warm(args):
    mpath = os.path.abspath(args.manifest)
    # manifests live at <cache-root>/manifests/<service>.json
    root = args.cache or os.path.dirname(os.path.dirname(mpath))
    try:
        entries = _load_manifest(mpath)
    except (OSError, ValueError) as e:
        sys.stderr.write(
            f"[compilecache] cannot read manifest {mpath}: {e}\n"
        )
        return 2
    store = ArtifactStore(root)

    def missing():
        return [
            e for e in entries if not store.contains(e["store_key"])
        ]

    gone = missing()
    if gone and args.builder:
        print(
            f"[compilecache] warm: {len(gone)}/{len(entries)} "
            f"program(s) missing; building via {args.builder}"
        )
        _call_builder(args.builder, root)
        gone = missing()
    for e in entries:
        state = "MISSING" if e in gone else "ok"
        bucket = e.get("bucket")
        detail = f" bucket={bucket}" if bucket is not None else ""
        print(
            f"[compilecache]   {state:7s} {e.get('name', '?')}"
            f" kind={e.get('kind', '?')}{detail}"
        )
    print(
        f"[compilecache] warm: {len(entries) - len(gone)}/"
        f"{len(entries)} programs present in {root}"
    )
    return 3 if gone else 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.compilecache",
        description="persistent compile cache tooling",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    warm = sub.add_parser(
        "warm",
        help="verify (and with --builder, compile) every warmup-"
             "manifest entry ahead of deploy",
    )
    warm.add_argument(
        "--manifest", required=True,
        help="path to a <cache>/manifests/<service>.json warmup "
             "manifest",
    )
    warm.add_argument(
        "--cache", default=None,
        help="cache root (default: derived from the manifest path)",
    )
    warm.add_argument(
        "--builder", default=None,
        help="module:callable that builds the service's engines "
             "against the cache (called with the cache directory); "
             "EngineConfig(compile_cache=...) persists every program "
             "as a side effect of the build",
    )
    args = parser.parse_args(argv)
    if args.cmd == "warm":
        return _warm(args)
    parser.error(f"unknown command {args.cmd!r}")


if __name__ == "__main__":
    sys.exit(main())
