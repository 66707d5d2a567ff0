"""Flight recorder: a bounded ring of recent events + crash-time dump
(counterpart of ``paddle_tpu/observability/flight.py``).

Product code appends cheap host-side events (program captures from the
compile log, ``jit_events``; fault-injection fires, journal replays and
append errors, preemptions, finished-request timelines, one sample per
non-idle serving step from ``stepstats``) into bounded rings that cost
one deque append per event and never grow. ``dump`` writes the rings,
the compile log, a metrics snapshot and the caller's probe snapshots to
one JSON file, on ``SIGUSR2`` (:func:`install_signal_handler`), on an
engine error, or when a caller asks; :func:`find_dumps` lists them.

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
    "record_step_sample", "step_samples",
    "dump_dir", "find_dumps", "install_signal_handler",
]

_DUMP_PREFIX = "paddle_tpu-flight-"


class FlightRecorder:
    """Thread-safe bounded event ring."""

    def __init__(self, capacity=512, timeline_capacity=64,
                 step_sample_capacity=64):
        self._events = deque(maxlen=int(capacity))
        # last-N finished/aborted request timelines (serving feeds one
        # phase-breakdown dict per completed request): a postmortem
        # shows what requests were DOING — queue waits, chunk counts,
        # preemptions — not just counters
        self._timelines = deque(maxlen=int(timeline_capacity))
        # last-N serving step samples (observability/stepstats.py feeds
        # one per non-idle engine step): where step time went right
        # before the failure — launch walls per program, occupancy,
        # queue depth, KV headroom
        self._step_samples = deque(maxlen=int(step_sample_capacity))
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

    def record_step_sample(self, entry):
        """Append one serving step sample (a JSON-friendly dict; one
        deque append — same cost contract as :meth:`record`)."""
        with self._lock:
            self._step_samples.append(entry)

    def step_samples(self):
        with self._lock:
            return [dict(s) for s in self._step_samples]

    def clear(self):
        with self._lock:
            self._events.clear()
            self._timelines.clear()
            self._step_samples.clear()

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


def record_step_sample(entry):
    """Append a serving step sample to the process-wide ring."""
    _recorder.record_step_sample(entry)


def step_samples():
    """The process-wide recorder's last-N serving step samples."""
    return _recorder.step_samples()


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
    """Write the postmortem file: ring events, request timelines, step
    samples, the compile log, a metrics snapshot, and ``probes`` (name ->
    snapshot dict, e.g. ``Engine.health()``). Returns the file path, or
    None after degrading a failure to a warning."""
    from ..resilience import faults
    from . import jit_events, metrics

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
            "step_samples": _json_safe(_recorder.step_samples()),
            "compile_log": _json_safe(jit_events.compile_log()),
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


def find_dumps(directory=None):
    """Postmortem files in ``directory`` (default: :func:`dump_dir`),
    newest first."""
    d = directory or dump_dir()
    try:
        names = [
            n for n in os.listdir(d)
            if n.startswith(_DUMP_PREFIX) and n.endswith(".json")
        ]
    except OSError:
        return []
    paths = [os.path.join(d, n) for n in names]

    def mtime(p):
        # a dump deleted between listdir and stat sorts last, not crash
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    return sorted(paths, key=mtime, reverse=True)


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
