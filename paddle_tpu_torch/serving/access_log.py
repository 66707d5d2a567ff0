"""Structured JSONL access log: one line per finished request
(counterpart of ``paddle_tpu/serving/access_log.py``, the same schema and
files).

Each line is one JSON object (rid, trace id, engine, tenant,
prompt/output lengths, finish reason, and the full
:class:`~.request.RequestTimeline` phase breakdown), written at
request-finish time:

  * **Write discipline**: one unbuffered ``write()`` per line — SIGKILL
    leaves at most one torn final line, which the reader skips —
    rotation into ``access-<n>.jsonl`` segments at ``rotate_bytes``
    with the oldest segments deleted beyond ``keep_files``. No fsync on
    the line path: this is telemetry, not durability (the journal owns
    delivery).
  * **Degradation contract**: every write/rotate failure — including
    the injected ``obs.accesslog`` fault — degrades to a warn-once plus
    ``paddle_tpu_serving_accesslog_*`` counters (pull-time weakref
    collector view). An access log must never take down the serving it
    describes.
  * **Offline reader**: :func:`iter_records` / :func:`load_directory`.

``resolve_access_log`` caches instances per directory, so engines of one
process that share an ``EngineConfig`` append to ONE log instead of
racing rotations.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
import warnings
import weakref

from ..resilience import faults

__all__ = ["AccessLog", "iter_records", "load_directory",
           "record_finish", "resolve_access_log"]

_FILE_RE = re.compile(r"^access-(\d{8})\.jsonl$")

# monotonic ids for the collector-view label (labels must never alias
# across log lifetimes — the engine/journal counter rationale)
_log_counter = itertools.count(1)

_COUNTERS = {
    "records_written": "paddle_tpu_serving_accesslog_records_total",
    "bytes_written": "paddle_tpu_serving_accesslog_bytes_total",
    "write_errors": "paddle_tpu_serving_accesslog_errors_total",
    "rotations": "paddle_tpu_serving_accesslog_rotations_total",
}


def _register_view(log, log_id):
    """Pull-time counter view (weakref: a collected log's view
    unregisters itself). Best-effort — telemetry about telemetry must
    never fail the caller."""
    try:
        from ..observability import MetricFamily, get_registry
    except Exception:
        # observability is optional here
        return
    ref = weakref.ref(log)
    label = {"log": log_id}

    def collect():
        al = ref()
        if al is None:
            return None
        return [
            MetricFamily(series, "counter").add(getattr(al, attr), label)
            for attr, series in _COUNTERS.items()
        ]

    try:
        get_registry().register_collector(
            f"serving.accesslog.{log_id}", collect
        )
    except Exception:
        # telemetry is best-effort
        pass


class AccessLog:
    """Rotating JSONL writer (one line per finished request)."""

    def __init__(self, path, rotate_bytes=1 << 20, keep_files=8):
        if rotate_bytes < 1:
            raise ValueError(
                f"rotate_bytes must be >= 1, got {rotate_bytes}"
            )
        if keep_files < 1:
            raise ValueError(f"keep_files must be >= 1, got {keep_files}")
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.rotate_bytes = int(rotate_bytes)
        self.keep_files = int(keep_files)
        self._file = None
        self._name = None
        self._size = 0
        self._warned = False
        # resolve_access_log aliases every same-directory engine in
        # the process to ONE instance, and engines may step on
        # different threads — serialize the write/rotate path (one
        # uncontended acquire per finished request, not per token)
        self._lock = threading.Lock()
        # counters (plain attributes; exported by the collector view)
        self.records_written = 0
        self.bytes_written = 0
        self.write_errors = 0
        self.rotations = 0
        _register_view(self, f"{next(_log_counter)}")

    def files(self):
        """Log file names on disk, oldest first."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        return sorted(n for n in names if _FILE_RE.match(n))

    def log(self, record):
        """Append one JSON line. NEVER raises: failures (including the
        injected ``obs.accesslog`` fault) degrade to a warn-once plus
        the error counter — the record is dropped, serving goes on."""
        with self._lock:
            try:
                faults.fire(
                    "obs.accesslog", path=self.path,
                    rid=record.get("rid"),
                )
                line = (
                    json.dumps(record, separators=(",", ":")) + "\n"
                ).encode()
                if self._file is None:
                    self._open_file()
                if (self._size
                        and self._size + len(line) > self.rotate_bytes):
                    self._rotate()
                self._file.write(line)  # unbuffered: one syscall/line
                self._size += len(line)
                self.records_written += 1
                self.bytes_written += len(line)
            except Exception as e:
                # the degradation
                # contract: serving never goes fatal because its
                # access log did
                self.write_errors += 1
                if not self._warned:
                    self._warned = True
                    warnings.warn(
                        f"[accesslog] write to {self.path} failed "
                        f"({type(e).__name__}: {e}); record dropped — "
                        "serving continues with a lossy access log "
                        "(further failures are counted, not warned)",
                        stacklevel=2,
                    )

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    # -- segments ----------------------------------------------------------
    def _open_file(self):
        names = self.files()
        nxt = 1 + (
            int(_FILE_RE.match(names[-1]).group(1)) if names else 0
        )
        name = f"access-{nxt:08d}.jsonl"
        self._file = open(
            os.path.join(self.path, name), "ab", buffering=0
        )
        self._name = name
        self._size = os.fstat(self._file.fileno()).st_size

    def _rotate(self):
        self._file.close()
        # cleared BEFORE the reopen: if _open_file raises (transient
        # ENOSPC/EACCES), log()'s reopen guard must retry next call
        # instead of writing to the closed handle forever
        self._file = None
        self._open_file()
        self.rotations += 1
        names = self.files()
        for name in names[: max(0, len(names) - self.keep_files)]:
            try:
                os.remove(os.path.join(self.path, name))
            except OSError:
                pass  # unremovable files retry at the next rotation


def record_finish(req, latency=None, slo=None, access_log=None,
                  **scope):
    """The finish-time accounting for one completed request (called by
    ``Engine._finish``; the JAX package's fleet shares it too, so the
    schema stays one):

      * ``latency`` (phase-digest dict) gets the e2e/tpot samples and
        ``slo`` the window sample — SKIPPED for client aborts: a
        cancelled request (client hang-up) is not a latency sample;
      * the structured entry (rid, trace, ``scope`` labels such as
        ``engine=``, lengths, error, full timeline snapshot) ALWAYS
        lands in the flight timeline ring and, when ``access_log`` is
        set, as one JSONL line — aborts included, because postmortems
        and operators need to see them.

    Host-side, once per request; every failure degrades downstream
    (AccessLog.log never raises, flight is best-effort)."""
    import time as _time

    tl = req.timeline
    n_out = len(req.output_token_ids)
    tpot = tl.tpot_s(n_out)
    if req.finish_reason != "aborted":
        if latency is not None:
            latency["e2e"].record(tl.e2e_s)
            if tpot is not None:
                latency["tpot"].record(tpot)
        if slo is not None:
            slo.record(ttft_s=tl.ttft_s, tpot_s=tpot)
    entry = {
        "ts": _time.time(),
        "rid": req.request_id,
        "trace": req.trace_id,
        **scope,
        "prompt_tokens": len(req.prompt_token_ids),
        "output_tokens": n_out,
        "error": req.error,
    }
    # tenant attribution rides the Request itself (set by the QoS
    # front door, restored by journal replay)
    tenant = getattr(req, "tenant", None)
    if tenant is not None and "tenant" not in entry:
        entry["tenant"] = tenant
    entry.update(tl.snapshot(n_out))
    try:
        from ..observability import flight

        flight.record_timeline(entry)
    except Exception:
        # flight telemetry is best-effort
        pass
    if access_log is not None:
        access_log.log(entry)
    return entry


def iter_records(path):
    """Yield the JSON records of every ``access-*.jsonl`` under
    ``path``, oldest first. Torn tails (a crash's partial final line)
    and damaged lines are skipped, not fatal — the reader must work on
    the directory a SIGKILL left behind."""
    try:
        names = sorted(
            n for n in os.listdir(path) if _FILE_RE.match(n)
        )
    except OSError:
        return
    for name in names:
        try:
            with open(os.path.join(path, name), "rb") as f:
                data = f.read()
        except OSError:
            continue
        for line in data.split(b"\n"):
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue  # torn/damaged line: skip


def load_directory(path):
    """All records under ``path`` as a list."""
    return list(iter_records(path))


# one AccessLog per directory per process: two writers rotating the
# same directory would race each other's segment numbering (the lock
# closes the check-then-act window when two threads resolve the same
# dir at once)
_instances: dict = {}
_instances_lock = threading.Lock()


def resolve_access_log(log):
    """``EngineConfig(access_log=)`` accepts a directory path or a
    pre-built :class:`AccessLog`; same-path resolutions share one
    instance."""
    if isinstance(log, AccessLog):
        return log
    key = os.path.abspath(str(log))
    with _instances_lock:
        ref = _instances.get(key)
        cur = ref() if ref is not None else None
        if cur is None:
            cur = AccessLog(key)
            _instances[key] = weakref.ref(cur)
    return cur
