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
``mark_aot_hit`` waits for the compile cache (``compilecache/``), which
the port does not have yet.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from . import metrics as _metrics

__all__ = [
    "watch", "suppress", "compile_log", "clear_compile_log",
    "retraces_after_warmup",
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
    ev = {
        "ts": time.time(),
        "fn": name,
        "kind": kind,
        "signature": signature,
        "trace_no": count,
        "retrace": retrace,
        "elapsed_s": elapsed_s,
    }
    with _lock:
        _log.append(ev)
    from . import flight

    flight.record(
        "compile", name, kind=kind, signature=signature, retrace=retrace,
        elapsed_s=elapsed_s,
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
