"""Flight recorder: a bounded ring of recent events + crash-time dump
(counterpart of ``paddle_tpu/observability/flight.py``, without the
compile log and the step-sample ring, whose modules are not ported).

Product code appends cheap host-side events (fault-injection fires,
journal replays and append errors, finished-request timelines) into a
ring that costs one deque append per event and never grows. ``dump``
writes the ring, the finished-request timelines, a metrics snapshot and
the caller's probe snapshots to one JSON file, on ``SIGUSR2``
(:func:`install_signal_handler`) or when a caller asks.

Dumps land under ``$PADDLE_TPU_FLIGHT_DIR`` (default: the system temp
dir) as ``paddle_tpu-flight-<pid>-<n>.json``. Dumping is an exporter: it
fires the ``obs.export`` fault site and degrades every failure to a
warning.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time
import warnings
from collections import deque

__all__ = [
    "FlightRecorder", "get_flight_recorder", "record", "dump",
    "record_timeline", "timelines",
    "dump_dir", "install_signal_handler",
]

_DUMP_PREFIX = "paddle_tpu-flight-"


class FlightRecorder:
    """Thread-safe bounded event ring."""

    def __init__(self, capacity=512, timeline_capacity=64):
        self._events = deque(maxlen=int(capacity))
        # last-N finished/aborted request timelines (serving feeds one
        # phase-breakdown dict per completed request): a postmortem
        # shows what requests were DOING — queue waits, chunk counts,
        # preemptions — not just counters
        self._timelines = deque(maxlen=int(timeline_capacity))
        self._lock = threading.Lock()
        self.dumps = 0          # postmortems written by this recorder

    def record(self, category, name, **data):
        """Append one event. Values should be JSON-friendly scalars;
        anything else is stringified at dump time, never here (the
        recording path stays allocation-cheap)."""
        ev = {"ts": time.time(), "category": category, "name": name}
        if data:
            ev.update(data)
        with self._lock:
            self._events.append(ev)

    def events(self):
        with self._lock:
            return [dict(ev) for ev in self._events]

    def record_timeline(self, entry):
        """Append one finished-request timeline (a JSON-friendly dict;
        one deque append — same cost contract as :meth:`record`)."""
        with self._lock:
            self._timelines.append(entry)

    def timelines(self):
        with self._lock:
            return [dict(t) for t in self._timelines]

    def clear(self):
        with self._lock:
            self._events.clear()
            self._timelines.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)


_recorder = FlightRecorder()
_dump_lock = threading.Lock()


def get_flight_recorder():
    return _recorder


def record(category, name, **data):
    """Append an event to the process-wide flight recorder."""
    _recorder.record(category, name, **data)


def record_timeline(entry):
    """Append a finished-request timeline to the process-wide ring."""
    _recorder.record_timeline(entry)


def timelines():
    """The process-wide recorder's last-N request timelines."""
    return _recorder.timelines()


def dump_dir():
    return os.environ.get("PADDLE_TPU_FLIGHT_DIR") or tempfile.gettempdir()


def _json_safe(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(k): _json_safe(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_json_safe(v) for v in obj]
        return repr(obj)


def dump(reason, path=None, probes=None):
    """Write the postmortem file: ring events, request timelines, a
    metrics snapshot, and ``probes`` (name -> snapshot dict, e.g.
    ``Engine.health()``). Returns the file path, or None after degrading
    a failure to a warning."""
    from ..resilience import faults
    from . import metrics

    try:
        faults.fire("obs.export", what="flight", reason=reason)
        if path is None:
            # name allocation under a lock: a signal-handler dump and a
            # caller's dump can fire together, and two dumps
            # interleaving into one file is exactly the torn postmortem
            # the tmp+replace dance exists to prevent
            with _dump_lock:
                _recorder.dumps += 1
                n = _recorder.dumps
            path = os.path.join(
                dump_dir(),
                f"{_DUMP_PREFIX}{os.getpid()}-{n:03d}.json",
            )
        payload = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "argv": sys.argv,
            "events": _json_safe(_recorder.events()),
            "request_timelines": _json_safe(_recorder.timelines()),
            "metrics": _json_safe(metrics.get_registry().snapshot()),
            "probes": _json_safe(probes or {}),
        }
        tmp = f"{path}.{os.getpid()}-{threading.get_ident():x}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)  # a torn postmortem helps nobody
        sys.stderr.write(f"[flight] {reason}: dumped {path}\n")
        return path
    except Exception as e:
        warnings.warn(
            f"flight-recorder dump ({reason!r}) failed (degraded, "
            f"nothing crashed): {e!r}",
            stacklevel=2,
        )
        return None


_signal_installed = False


def install_signal_handler(signum=None):
    """Install the ``SIGUSR2 -> dump("sigusr2")`` handler (idempotent;
    main thread only — a no-op elsewhere, returns True iff
    installed)."""
    global _signal_installed
    if _signal_installed:
        return True
    signum = signum if signum is not None else getattr(
        signal, "SIGUSR2", None
    )
    if signum is None:
        return False

    def _handler(sig, frame):
        dump("sigusr2")

    try:
        signal.signal(signum, _handler)
    except ValueError:  # not the main thread
        return False
    _signal_installed = True
    return True
