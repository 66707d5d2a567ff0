"""Compile/retrace event log (counterpart of
``paddle_tpu/observability/jit_events.py``).

In the port a "compile" is a program capture: the serving engine builds
each step program once (``serving/programs.py``: an eager warm-up, then
the ``torch.cuda.graph`` capture on the card, or the eager function on
the CPU) and replays it on every later step. Each capture records an
event (fn, kind, signature, elapsed wall clock of the warm-up and the
capture) into a bounded log, increments
``paddle_tpu_jit_compiles_total{kind}``, and lands in the flight
recorder. A capture of a *(fn, kind, signature)* that was already
captured once is a **retrace after warmup** — a program family that
keeps rebuilding what it should replay — and additionally bumps the
alarmable ``paddle_tpu_jit_retraces_after_warmup_total{kind}`` counter.

Mechanics: the engine wraps each program build in :func:`watch`; the
capture is explicit, so JAX's ``mark_traced`` (called from inside a
traced body, which only runs while XLA traces) collapses into the watch
itself: a watch whose body completes records one event. The port's
``jit.TrainStep`` runs eagerly and captures nothing, so it records
nothing. :class:`suppress` masks the recording for its dynamic extent
on the calling thread: the static analyzer (``analysis/``) wraps its
traces in it, so analysis never reads as capture activity.
``mark_aot_hit`` records a program the compile cache (``compilecache/``)
restored instead of building it: its own ``kind="aot-hit"``, counted in
``paddle_tpu_jit_aot_hits_total`` and never as a capture or a retrace.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from . import metrics as _metrics

__all__ = [
    "watch", "mark_aot_hit", "suppress", "compile_log",
    "clear_compile_log", "retraces_after_warmup", "aot_hits",
]

_lock = threading.Lock()
_tls = threading.local()
_log: deque = deque(maxlen=256)
_seen: dict = {}      # (name, kind, signature) -> capture count

_compiles = _metrics.counter(
    "paddle_tpu_jit_compiles_total",
    "program captures recorded by the serving engine", ("kind",),
)
_retraces = _metrics.counter(
    "paddle_tpu_jit_retraces_after_warmup_total",
    "captures of a (fn, signature) pair that was already captured once — "
    "a program rebuilt where it should be replayed", ("kind",),
)
_aot_hits = _metrics.counter(
    "paddle_tpu_jit_aot_hits_total",
    "programs restored from the persistent compile cache instead of "
    "built (compilecache warm restarts)",
)


def _suppressed():
    return getattr(_tls, "suppress", 0) > 0


class suppress:
    """Mask capture-event recording for the dynamic extent (the
    trace-only analyzer's traces never read as captures)."""

    def __enter__(self):
        _tls.suppress = getattr(_tls, "suppress", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.suppress -= 1
        return False


class watch:
    """Wrap one program build; a body that completes records one
    capture event with the build's elapsed wall time::

        with jit_events.watch("serving.decode", kind="serving",
                              signature="1:any_sample=False"):
            prog = Program(fn, device, ...)
    """

    def __init__(self, name, kind="jit", signature=""):
        self.name = name
        self.kind = kind
        self.signature = str(signature)
        self.event = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and not _suppressed():
            self.event = _record(self.name, self.kind, self.signature,
                                 time.perf_counter() - self._t0)
        return False


def _record(name, kind, signature, elapsed_s):
    key = (name, kind, signature)
    with _lock:
        count = _seen[key] = _seen.get(key, 0) + 1
    retrace = count > 1
    _compiles.inc(kind=kind)
    if retrace:
        _retraces.inc(kind=kind)
    return _emit({
        "ts": time.time(),
        "fn": name,
        "kind": kind,
        "signature": signature,
        "trace_no": count,
        "retrace": retrace,
        "elapsed_s": elapsed_s,
    })


def mark_aot_hit(name, signature="", elapsed_s=None):
    """Record a program restored from the persistent compile cache
    (``paddle_tpu_torch.compilecache``) instead of built. Logged under
    its own ``kind="aot-hit"``: it bumps neither
    ``paddle_tpu_jit_compiles_total`` nor the warm-retrace alarm, so a
    warm restart that replays its manifest reads as zero compile
    activity."""
    if _suppressed():
        return None
    _aot_hits.inc()
    return _emit({
        "ts": time.time(),
        "fn": name,
        "kind": "aot-hit",
        "signature": str(signature),
        "trace_no": 0,
        "retrace": False,
        "elapsed_s": elapsed_s,
    })


def aot_hits():
    """Total programs restored from the persistent compile cache."""
    return sum(v for _, _, v in _aot_hits.family().samples)


def _emit(ev):
    with _lock:
        _log.append(ev)
    from . import flight

    flight.record(
        "compile", ev["fn"], kind=ev["kind"], signature=ev["signature"],
        retrace=ev["retrace"], elapsed_s=ev["elapsed_s"],
    )
    return ev


def compile_log():
    """The bounded compile/retrace event log, oldest first."""
    with _lock:
        return [dict(ev) for ev in _log]


def clear_compile_log():
    """Reset the log and the warmup bookkeeping (tests)."""
    with _lock:
        _log.clear()
        _seen.clear()


def retraces_after_warmup(kind=None):
    """Total retrace-after-warmup count (optionally for one kind)."""
    fam = _retraces.family()
    return sum(
        v for _, labels, v in fam.samples
        if kind is None or labels.get("kind") == kind
    )
