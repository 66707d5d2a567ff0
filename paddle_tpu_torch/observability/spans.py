"""Structured spans: trace/span ids over ``torch.profiler`` ranges
(counterpart of ``paddle_tpu/observability/spans.py``).

Every span carries a ``trace_id`` shared by the whole request and a fresh
``span_id``; the current span rides a contextvar so nesting needs no
plumbing, and a compact **traceparent** string (``"<trace_id>-
<span_id>"``) crosses process boundaries: the HTTP front door continues
an inbound W3C ``traceparent`` with :func:`remote_span`, so the access
log's ``trace`` field carries the caller's trace id.

While a ``torch.profiler`` session records, each span also enters a
``torch.profiler.record_function`` range, so spans show up in the trace
next to the kernels; finished spans land in a bounded in-memory buffer
exportable as Chrome-trace JSONL (:func:`export_chrome_trace`).
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
import warnings
from collections import deque

import torch

__all__ = [
    "Span", "span", "remote_span", "current_span", "current_trace_id",
    "current_traceparent", "finished_spans", "export_chrome_trace",
]

_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_span", default=None
)

_buf_lock = threading.Lock()
_finished: deque = deque(maxlen=4096)

# id generation is on the per-step hot path: one os.urandom-seeded PRNG
# at import, then getrandbits per id (no syscall per span). Not
# cryptographic — span ids are correlation keys, not secrets.
_id_rng = random.Random(os.urandom(16))
_id_lock = threading.Lock()


def _new_id(nbytes=8):
    with _id_lock:
        return f"{_id_rng.getrandbits(nbytes * 8):0{nbytes * 2}x}"


class Span:
    """One named range. ``trace_id`` is inherited from the enclosing
    span (or remote parent) and minted fresh at a trace root."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs",
        "start_us", "duration_s", "_t0", "_record",
    )

    def __init__(self, name, trace_id=None, parent_id=None, **attrs):
        self.name = name
        self.trace_id = trace_id or _new_id(16)
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.attrs = attrs
        self.start_us = None
        self.duration_s = None
        self._t0 = None
        self._record = None

    @property
    def traceparent(self):
        return f"{self.trace_id}-{self.span_id}"

    def to_chrome_event(self):
        """One Chrome-trace "complete" (ph=X) event."""
        return {
            "name": self.name,
            "cat": "paddle_tpu",
            "ph": "X",
            "ts": self.start_us,
            "dur": (self.duration_s or 0.0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": {
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                **self.attrs,
            },
        }

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}, "
                f"span={self.span_id}, parent={self.parent_id})")


class _SpanScope:
    def __init__(self, sp):
        self.span = sp
        self._token = None

    def __enter__(self):
        sp = self.span
        sp.start_us = time.time() * 1e6
        sp._t0 = time.perf_counter()
        # profiler integration only while a session is RECORDING: an
        # always-on range would cost microseconds per span with nobody
        # listening
        if torch.autograd.profiler._is_profiler_enabled:
            sp._record = torch.profiler.record_function(sp.name)
            sp._record.__enter__()
        self._token = _current.set(sp)
        return sp

    def __exit__(self, *exc):
        sp = self.span
        _current.reset(self._token)
        if sp._record is not None:
            sp._record.__exit__(None, None, None)
            sp._record = None
        sp.duration_s = time.perf_counter() - sp._t0
        with _buf_lock:
            _finished.append(sp)
        return False


def span(name, **attrs):
    """Context manager opening a child span of the current one (a fresh
    trace root when there is none)::

        with observability.span("serving.decode", step=i):
            ...
    """
    parent = _current.get()
    if parent is not None:
        sp = Span(
            name, trace_id=parent.trace_id, parent_id=parent.span_id,
            **attrs,
        )
    else:
        sp = Span(name, **attrs)
    return _SpanScope(sp)


def remote_span(name, traceparent, **attrs):
    """Server-side continuation of a propagated trace: opens a span
    whose parent is the remote caller's span. ``traceparent`` is the
    ``"<trace_id>-<span_id>"`` string from the wire; None (caller had
    no active span) degrades to a no-op."""
    if not traceparent:
        return contextlib.nullcontext()
    try:
        trace_id, parent_id = traceparent.rsplit("-", 1)
    except ValueError:
        return contextlib.nullcontext()
    return _SpanScope(
        Span(name, trace_id=trace_id, parent_id=parent_id, **attrs)
    )


def current_span():
    return _current.get()


def current_trace_id():
    sp = _current.get()
    return None if sp is None else sp.trace_id


def current_traceparent():
    """The propagation string a caller attaches to outbound calls; None
    when no span is open."""
    sp = _current.get()
    return None if sp is None else sp.traceparent


def finished_spans():
    """Snapshot of the bounded finished-span buffer (newest last)."""
    with _buf_lock:
        return list(_finished)


def export_chrome_trace(path):
    """Write the finished-span buffer as Chrome-trace JSONL (one event
    object per line). Exporter contract: never raises into the
    caller's serving/training loop — failures (and the
    injected ``obs.export`` fault site) degrade to a warning and return
    None; returns ``path`` on success."""
    from ..resilience import faults

    try:
        faults.fire("obs.export", what="chrome_trace", path=path)
        spans = finished_spans()
        with open(path, "w") as f:
            for sp in spans:
                f.write(json.dumps(sp.to_chrome_event()) + "\n")
        return path
    except Exception as e:
        warnings.warn(
            f"chrome-trace export to {path!r} failed (degraded, "
            f"nothing crashed): {e!r}",
            stacklevel=2,
        )
        return None
