"""Durable request journal: a write-ahead log that makes serving requests
survive the death of the serving process (counterpart of
``paddle_tpu/serving/journal.py``, the same on-disk format: segments
either package writes replay in the other).

  * **Records** — crc32-framed, JSON-payload, append-only:

        ADMIT  (``"A"``)  request id, prompt token ids, the full
                          SamplingParams (incl. the per-request
                          ``seed``), wall-clock arrival, the tenant, and
                          the emit cursor (tokens already produced —
                          nonzero only for re-admissions after a
                          recovery, a migration or a spill), and the
                          host-spill handle ``kv`` ([key, tokens]) when
                          the request's KV is parked in the spill tier
        EMIT   (``"E"``)  tokens appended since the last flush,
                          batched per step across every live request
        FINISH (``"F"``)  terminal reason (length/stop/timeout/error)
        ABORT  (``"X"``)  client abort (a FINISH with reason="aborted")
        EPOCH  (``"R"``)  a scaling-op bracket (advisory)

    Framing is ``<u32 length><u32 crc32(payload)><payload>``: a
    crc-damaged record with an intact length is *skipped* (warn +
    counter), a record whose frame cannot be parsed truncates the
    segment there (torn tail — the crash left a partial write).

  * **Segments** — ``wal-<n>.seg`` files under the journal directory.
    Appends are buffered and written with ONE ``write()`` per batch
    (SIGKILL-consistent: the kernel owns the bytes once the write
    returns). Batches carrying ADMIT/FINISH/ABORT — the records that
    decide delivery — write at the step they were buffered; pure-EMIT
    batches may group across steps for up to ``write_interval_s``
    (a lost EMIT is re-derived by the replay recompute). ``fsync`` is
    grouped on its own interval (power-loss window =
    ``fsync_interval_s``) and always taken on rotation and close. Every
    process incarnation opens a FRESH segment (headered with the journal
    generation + engine seed), so a torn tail can only ever sit at the
    end of a dead incarnation's last segment.

  * **Compaction** — a segment whose every touched request has finished
    is deleted. Recovery re-ADMITs unfinished requests into the live
    segment (cursor carried), which lets the dead incarnation's segments
    retire as soon as the recovered work drains.

  * **Replay** — ``replay()`` walks every segment in order and folds
    records into per-request entries (latest ADMIT wins, EMITs extend
    its cursor, FINISH/ABORT closes). The engine re-admits the
    unfinished entries at the HEAD of its queue through ``resume()``'s
    re-prefill (``prompt + output[:-1]``), so no already-emitted token
    is produced twice; on the CPU in f32 greedy continuations are
    token-identical to an uninterrupted run. An entry whose ``kv`` handle
    the spill tier's disk level still holds (``EngineConfig(spill_dir=)``)
    is restored from it instead of re-prefilled. Requests whose ``ttl_s``
    lapsed while the process was down are finished with ``"timeout"``
    instead of re-admitted.

Failure policy: durability must never take down serving. Every append,
flush, rotation and replay failure — including the injected
``journal.append`` / ``journal.replay`` faults — degrades to a warning
plus ``paddle_tpu_serving_journal_*`` counters; the engine keeps
stepping with a lossy (or absent) journal.

Single-writer contract: one live process per journal directory. A
recovering process may open the directory only after the previous
incarnation is dead (replay's torn-tail truncation rewrites the dead
incarnation's last segment in place).
"""
from __future__ import annotations

import itertools
import json
import os
import re
import struct
import time
import warnings
import weakref
import zlib

from ..resilience import faults

__all__ = ["Journal", "ReplayEntry", "resolve_journal"]

_FRAME = struct.Struct("<II")      # payload length, crc32(payload)
_MAX_RECORD = 1 << 26              # frame-length sanity cap (64 MiB)
_SEG_RE = re.compile(r"^wal-(\d{8})\.seg$")

# monotonic journal ids for the collector-view label (same rationale
# as the engine counter: labels must never alias across lifetimes)
_journal_counter = itertools.count(1)

# counter attribute -> exported series (all under the namespace the
# acceptance contract names: paddle_tpu_serving_journal_*). The
# counters are plain attributes bumped inline — the flush path is per
# scheduler step, so it pays ZERO registry cost; the registry PULLS
# at scrape time through a weakref collector view (the EngineMetrics
# pattern).
_JOURNAL_COUNTERS = {
    "records_written": "paddle_tpu_serving_journal_records_total",
    "writes": "paddle_tpu_serving_journal_writes_total",
    "bytes_written": "paddle_tpu_serving_journal_bytes_total",
    "append_errors": "paddle_tpu_serving_journal_append_errors_total",
    "replays": "paddle_tpu_serving_journal_replays_total",
    "replayed_requests":
        "paddle_tpu_serving_journal_replayed_requests_total",
    "corrupt_records":
        "paddle_tpu_serving_journal_corrupt_records_total",
    "torn_tails": "paddle_tpu_serving_journal_torn_tails_total",
    "compacted_segments":
        "paddle_tpu_serving_journal_compacted_segments_total",
    "replay_errors": "paddle_tpu_serving_journal_replay_errors_total",
    "seed_mismatches":
        "paddle_tpu_serving_journal_seed_mismatches_total",
    "fsyncs": "paddle_tpu_serving_journal_fsyncs_total",
}


def _register_view(journal, journal_id):
    """Pull-time collector over one journal (weakref: a collected
    journal's view unregisters itself). Best-effort: a metrics
    failure must never become a journal failure."""
    try:
        from ..observability import MetricFamily, get_registry
    except Exception:
        # observability is optional here
        return
    ref = weakref.ref(journal)
    label = {"journal": journal_id}

    def collect():
        j = ref()
        if j is None:
            return None
        return [
            MetricFamily(series, "counter").add(getattr(j, attr), label)
            for attr, series in _JOURNAL_COUNTERS.items()
        ]

    try:
        get_registry().register_collector(
            f"serving.journal.{journal_id}", collect
        )
    except Exception:
        # telemetry is best-effort
        pass


def _flight_record(name, **data):
    try:
        from ..observability import flight

        flight.record("journal", name, **data)
    except Exception:
        # flight telemetry is best-effort
        pass


def _fsync_dir(path):
    """fsync a directory (its entries: a new or removed segment), best
    effort: some filesystems refuse a directory fsync, and the append
    path degrades on its own terms."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class ReplayEntry:
    """One unfinished request recovered from the journal."""

    __slots__ = ("rid", "prompt", "params", "out", "ts", "tenant", "kv")

    def __init__(self, rid, prompt, params, out, ts, tenant=None,
                 kv=None):
        self.rid = rid          # request id (int or str, as journaled)
        self.prompt = prompt    # prompt token ids
        self.params = params    # SamplingParams dict (to_dict form)
        self.out = out          # tokens already emitted (the cursor)
        self.ts = ts            # wall-clock admission time (time.time)
        self.tenant = tenant    # QoS tenant id (None pre-QoS journals)
        self.kv = kv            # [spill_key, spill_tokens] handle into
        #                         the host spill tier, or None (never
        #                         spilled)

    def __repr__(self):
        return (
            f"ReplayEntry(rid={self.rid!r}, prompt={len(self.prompt)} "
            f"tok, out={len(self.out)} tok)"
        )


def resolve_journal(journal, seed=None):
    """``EngineConfig(journal=)`` accepts a directory path or a
    pre-built :class:`Journal`."""
    if isinstance(journal, Journal):
        return journal
    return Journal(str(journal), seed=seed)


def restore_entries(journal, entries, build):
    """The replay fold behind Engine recovery: for each unfinished
    :class:`ReplayEntry`, reconstruct the request via ``build(entry,
    params)`` (returning a Request, or any object carrying one as
    ``.request``), restore its emitted tokens, and re-anchor its TTL
    deadline at the journaled wall-clock arrival.
    Entries whose TTL lapsed while the process was down are retired in
    the journal as ``"timeout"`` instead of rebuilt; entries that
    cannot be reconstructed (a field a crc-valid but semantically
    damaged record lost) are dropped with a warning and retired as
    ``"error"`` — recovery must never be fatal. Returns
    ``(live_objects, expired_count)``; the caller queues the live
    objects, re-journals their ADMITs, and flushes."""
    from .request import SamplingParams

    now = time.time()
    live, expired = [], 0
    for e in entries:
        try:
            params = SamplingParams.from_dict(e.params)
            remaining = None
            if params.ttl_s is not None and e.ts is not None:
                remaining = e.ts + params.ttl_s - now
                if remaining <= 0:
                    expired += 1
                    journal.finish_rid(e.rid, "timeout")
                    continue
            obj = build(e, params)
            req = getattr(obj, "request", obj)
            req.output_token_ids = list(e.out)
            if getattr(e, "tenant", None) is not None:
                req.tenant = e.tenant
            kv = getattr(e, "kv", None)
            if kv:
                # re-anchor the host-spill handle: if the tier (or its
                # disk level) still holds the key, re-admission restores
                # the KV instead of re-prefilling it
                req.spill_key = kv[0]
                req.spill_tokens = int(kv[1])
            if e.ts is not None:
                # timeline coherence: anchor arrival at the journaled
                # wall-clock admission (the same field the TTL math
                # uses), mapped into this incarnation's perf_counter
                # domain. Without this a recovered request's TTFT/e2e
                # would be measured from the RESTART — the post-crash
                # latency digests would report impossibly fast
                # recoveries instead of the downtime the client saw.
                age = max(0.0, now - e.ts)
                req.arrival_time = time.perf_counter() - age
                req.timeline.arrival = req.arrival_time
                req.timeline.recovered = True
            if remaining is not None:
                # anchored at the ORIGINAL admission, not the restart
                # (perf_counter does not survive the process)
                req.deadline = time.perf_counter() + remaining
        except Exception as exc:
            # the degradation contract: one unreconstructable entry must
            # not keep the engine from serving the rest
            warnings.warn(
                f"[journal] dropping unreplayable request {e.rid!r}: "
                f"{type(exc).__name__}: {exc}",
                stacklevel=2,
            )
            journal.finish_rid(e.rid, "error")
            continue
        live.append(obj)
    return live, expired


class Journal:
    """Append-only crc-framed request WAL over segment files.

    The writer API mirrors the request lifecycle — :meth:`admit`,
    :meth:`emit`, :meth:`finish` buffer records; :meth:`flush` writes
    the step's batch with one ``write()``. :meth:`replay` must run
    before the first append of a new incarnation (the engine calls it
    before accepting traffic)."""

    def __init__(self, path, segment_bytes=1 << 20, fsync_interval_s=0.25,
                 write_interval_s=0.02, seed=None):
        if segment_bytes < 1:
            raise ValueError(
                f"segment_bytes must be >= 1, got {segment_bytes}"
            )
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        # None: fsync only on rotate/close; 0: every write; >0: at most
        # once per interval (group commit — the power-loss window)
        self.fsync_interval_s = fsync_interval_s
        # pure-EMIT buffers may batch across steps for up to this long
        # before the write() syscall (0 writes every flush). Safe by
        # construction: a lost EMIT is re-derived by the replay
        # recompute — only ADMIT/FINISH/ABORT decide delivery, and those
        # always write immediately.
        self.write_interval_s = float(write_interval_s)
        self.seed = seed
        self.generation = 1           # prior incarnations + 1 (replay)
        self._buffer: list = []       # record dicts pending write
        self._urgent = False          # buffer holds ADMIT/FINISH/ABORT
        self._open: set = set()      # admitted-not-finished rids
        self._touched: dict = {}      # segment name -> set of rids
        self._finished_since_compact = False
        self._seg_file = None
        self._seg_name = None
        self._seg_size = 0
        self._last_fsync = 0.0
        self._last_write = 0.0
        self._replayed = False
        self._append_warned = False
        self._epoch = 0               # replica-epoch counter (R records)
        self.replay_report = None
        # counters (plain attributes; exported by the collector view)
        self.records_written = 0
        self.writes = 0
        self.bytes_written = 0
        self.append_errors = 0
        self.replays = 0
        self.replayed_requests = 0
        self.corrupt_records = 0
        self.torn_tails = 0
        self.compacted_segments = 0
        self.replay_errors = 0
        self.seed_mismatches = 0
        self.fsyncs = 0               # segment fsyncs (group commits)
        _register_view(self, f"{next(_journal_counter)}")

    # -- introspection -------------------------------------------------------
    def segments(self):
        """Segment file names on disk, oldest first."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        return sorted(n for n in names if _SEG_RE.match(n))

    def open_requests(self):
        """Rids admitted but not finished (snapshot)."""
        return set(self._open)

    # -- framing -------------------------------------------------------------
    @staticmethod
    def _frame(record):
        payload = json.dumps(record, separators=(",", ":")).encode()
        return _FRAME.pack(
            len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        ) + payload

    # -- writer API ----------------------------------------------------------
    def admit(self, req):
        """Buffer an ADMIT for ``req`` (a serving Request). Re-admits
        (failover / recovery) carry the emit cursor — the tokens
        already produced — so replay never double-counts them."""
        rid = req.request_id
        out = list(req.output_token_ids)
        rec = {
            "t": "A", "rid": rid, "p": list(req.prompt_token_ids),
            "sp": req.sampling_params.to_dict(), "out": out,
            "ts": time.time(),
        }
        # tenant attribution rides the ADMIT so a replay restores the
        # QoS accounting (quota/fair-share charges the right tenant)
        tenant = getattr(req, "tenant", None)
        if tenant is not None:
            rec["tn"] = tenant
        # the host-spill handle rides the ADMIT too: a re-admit after a
        # preempt or release journals [key, tokens] so a crash replay
        # re-anchors the restore (latest ADMIT wins, so a consumed handle
        # is cleared by the next re-admit)
        kv_key = getattr(req, "spill_key", None)
        if kv_key is not None:
            rec["kv"] = [kv_key, int(getattr(req, "spill_tokens", 0))]
        self._buffer.append(rec)
        self._urgent = True   # admissions are durable before dispatch
        self._open.add(_key(rid))
        req.journal_cursor = len(out)

    def emit(self, req):
        """Buffer the tokens ``req`` gained since its last emit.
        Consecutive emits merge into ONE batched EMIT record — the
        per-step flush writes a single record for the whole batch.
        This is the hot call (once per live slot per write): nothing
        here touches the registry, the clock, or the filesystem."""
        out = req.output_token_ids
        cursor = req.journal_cursor
        if len(out) <= cursor:
            return
        toks = out[cursor:]
        req.journal_cursor = len(out)
        buf = self._buffer
        if buf and buf[-1]["t"] == "E":
            buf[-1]["e"].append([req.request_id, toks])
        else:
            buf.append({"t": "E", "e": [[req.request_id, toks]]})

    def step_flush(self, reqs):
        """The per-step hook: called once per scheduler step with the
        live requests. When nothing urgent is buffered and the write
        interval has not elapsed, this is a two-comparison no-op —
        emit cursors are not even advanced; the new tokens simply stay
        on the Request objects until write time. Otherwise the live
        requests' new tokens are swept into one batched EMIT record
        and the whole buffer is written. This keeps the steady-state
        per-step journal cost at ~nothing."""
        if (not self._urgent
                and time.monotonic() - self._last_write
                < self.write_interval_s):
            return 0
        for r in reqs:
            if r is not None:
                self.emit(r)
        return self.flush(force=True)

    def finish(self, req, reason=None):
        """Buffer the request's trailing emits plus its terminal
        record (ABORT for client aborts, FINISH otherwise)."""
        self.emit(req)
        reason = reason or req.finish_reason
        self.finish_rid(req.request_id, reason)

    def finish_rid(self, rid, reason):
        """Terminal record by rid alone — recovery uses this to retire
        a journaled request that expired while the process was down
        (there is no live Request to hand to :meth:`finish`).

        NOTE: the rid stays in ``_open`` until the write carrying this
        record SUCCEEDS (see flush) — compaction eligibility must
        follow durability, not buffering, or a crash between deleting
        the ADMIT-holding segment and writing the FINISH would lose
        the request entirely (neither delivered nor replayable)."""
        if reason == "aborted":
            self._buffer.append({"t": "X", "rid": rid})
        else:
            self._buffer.append({"t": "F", "rid": rid, "r": reason})
        self._urgent = True   # completions are durable before delivery

    def epoch(self, op, replica=None):
        """Buffer a replica-epoch record: the JAX package's fleet
        brackets every scaling action with these (``"shrink-begin"`` /
        ``"shrink-end"``, one ``"scale-up"`` per spawn) so a replay can
        tell a completed scaling op from one a crash interrupted. They
        are advisory markers, not the delivery contract (that is
        latest-ADMIT-wins): ``*-begin`` ops unclosed by a later ``*-end``
        for the same replica are reported in
        ``replay_report["interrupted_ops"]``, and epoch numbering resumes
        past the journal's max after replay. Urgent like every lifecycle
        record; returns the epoch number."""
        self._epoch += 1
        rec = {"t": "R", "ep": self._epoch, "op": str(op),
               "ts": time.time()}
        if replica is not None:
            rec["rep"] = str(replica)
        self._buffer.append(rec)
        self._urgent = True
        return self._epoch

    def flush(self, force=False):
        """Write the buffered records (one ``write()``), group-fsync by
        interval, rotate + compact when due. Returns bytes written.

        Pure-EMIT buffers (no admission, no completion) may wait up to
        ``write_interval_s`` before the syscall: a crash in that window
        loses only tokens the replay recompute re-derives
        byte-identically. Buffers carrying ADMIT/FINISH/ABORT — the
        records that decide delivery — always write immediately.

        NEVER raises: any failure — including an injected
        ``journal.append`` fault — degrades to a warning + counters,
        and the buffered records are dropped (a lossy journal, warned
        once and counted; serving keeps going)."""
        if not self._buffer:
            return 0
        now = time.monotonic()
        if (not force and not self._urgent
                and now - self._last_write < self.write_interval_s):
            return 0
        records, self._buffer = self._buffer, []
        self._urgent = False
        try:
            faults.fire(
                "journal.append", path=self.path, records=len(records),
            )
            if self._seg_file is None:
                self._open_segment()
            data = b"".join(self._frame(r) for r in records)
            if (self._seg_size and
                    self._seg_size + len(data) > self.segment_bytes):
                self._rotate()
            # touched is updated BEFORE the write: a superset only ever
            # makes compaction more conservative, never unsafe
            touched = self._touched[self._seg_name]
            for r in records:
                touched.update(_record_rids(r))
            self._seg_file.write(data)   # unbuffered: ONE syscall
            self._seg_size += len(data)
            self._last_write = now
            # terminal records are ON DISK now: only at this point may
            # their requests stop protecting the segments that hold
            # their history (a dropped batch — the except below — must
            # leave them open, so compaction stays conservative)
            for r in records:
                if r["t"] in ("F", "X"):
                    self._open.discard(_key(r["rid"]))
                    self._finished_since_compact = True
            if self.fsync_interval_s is not None and (
                self.fsync_interval_s <= 0
                or now - self._last_fsync >= self.fsync_interval_s
            ):
                os.fsync(self._seg_file.fileno())
                self.fsyncs += 1
                self._last_fsync = now
            self.records_written += len(records)
            self.bytes_written += len(data)
            self.writes += 1
            if self._finished_since_compact and len(self._touched) > 1:
                # only when retired segments can actually exist — the
                # steady single-segment state pays nothing here
                self._finished_since_compact = False
                self._compact()
            return len(data)
        except Exception as e:
            # the degradation contract:
            # serving never goes fatal because durability did
            self.append_errors += 1
            _flight_record(
                "append-error", path=self.path,
                error=f"{type(e).__name__}: {e}",
                records=len(records),
            )
            if not self._append_warned:
                self._append_warned = True
                warnings.warn(
                    f"[journal] append to {self.path} failed "
                    f"({type(e).__name__}: {e}); {len(records)} "
                    "record(s) dropped — serving continues with a "
                    "lossy journal (further append failures are "
                    "counted, not warned)",
                    stacklevel=2,
                )
            return 0

    def close(self):
        """Flush, fsync, and close the live segment (clean shutdown;
        deliberately NOT called from any destructor — a crash must
        look like a crash)."""
        self.flush(force=True)
        if self._seg_file is not None:
            try:
                os.fsync(self._seg_file.fileno())
                self.fsyncs += 1
                self._seg_file.close()
            except OSError as e:
                self.append_errors += 1
                warnings.warn(
                    f"[journal] close of {self._seg_name} failed: {e}",
                    stacklevel=2,
                )
            self._seg_file = None

    # -- segments ------------------------------------------------------------
    def _open_segment(self):
        segs = self.segments()
        nxt = 1 + (
            int(_SEG_RE.match(segs[-1]).group(1)) if segs else 0
        )
        name = f"wal-{nxt:08d}.seg"
        path = os.path.join(self.path, name)
        # unbuffered: flush() writes ONE pre-joined byte string per
        # step batch, so the BufferedWriter layer is pure overhead
        self._seg_file = open(path, "ab", buffering=0)
        self._seg_name = name
        self._seg_size = 0
        self._touched.setdefault(name, set())
        header = self._frame({
            "t": "H", "v": 1, "gen": self.generation,
            "seed": self.seed,
        })
        self._seg_file.write(header)
        os.fsync(self._seg_file.fileno())
        self.fsyncs += 1
        self._seg_size += len(header)
        self._last_fsync = time.monotonic()
        _fsync_dir(self.path)

    def _rotate(self):
        """Close the live segment and start the next (fsync'd on both
        sides so the boundary is never torn), then try compaction."""
        os.fsync(self._seg_file.fileno())
        self.fsyncs += 1
        self._seg_file.close()
        self._open_segment()
        self._compact()

    def _compact(self):
        """Delete every non-live segment none of whose touched
        requests is still open. A segment replay never saw (no touched
        entry) is kept — unknown means not provably retired."""
        removed = 0
        for name in self.segments():
            if name == self._seg_name:
                continue
            touched = self._touched.get(name)
            if touched is None or touched & self._open:
                continue
            try:
                os.remove(os.path.join(self.path, name))
            except OSError:
                continue  # unremovable segments retry next compaction
            self._touched.pop(name, None)
            removed += 1
        if removed:
            self.compacted_segments += removed
            _fsync_dir(self.path)
        return removed

    # -- replay --------------------------------------------------------------
    def replay(self):
        """Fold every on-disk segment into per-request entries and
        return the UNFINISHED ones in admission order (the caller
        re-admits them at its queue head). Idempotent per instance:
        a second call returns ``[]`` — and across instances, the
        re-ADMIT records the caller writes (latest-ADMIT-wins keying)
        make a replay-of-a-replay admit nothing twice.

        Never raises: corrupt records are skipped, torn tails
        truncated, and a replay-level failure (injected
        ``journal.replay`` fault, unreadable directory) degrades to a
        warning + counter and an empty recovery."""
        if self._replayed:
            return []
        self._replayed = True
        try:
            return self._replay()
        except Exception as e:
            # the degradation contract:
            # a broken journal must not stop the engine from serving
            self.replay_errors += 1
            _flight_record(
                "replay-error", path=self.path,
                error=f"{type(e).__name__}: {e}",
            )
            warnings.warn(
                f"[journal] replay of {self.path} failed "
                f"({type(e).__name__}: {e}); recovering nothing",
                stacklevel=2,
            )
            self.replay_report = {"error": f"{type(e).__name__}: {e}"}
            return []

    def _replay(self):
        faults.fire("journal.replay", path=self.path)
        self.replays += 1
        entries: dict = {}
        order: dict = {}
        seq = 0
        generations = 0
        corrupt = torn = nrecords = 0
        seeds = []
        epoch_max = 0
        open_ops: dict = {}   # (op base, replica) -> epoch of begin
        for name in self.segments():
            spath = os.path.join(self.path, name)
            touched = self._touched.setdefault(name, set())
            with open(spath, "rb") as f:
                data = f.read()
            off = 0
            while off < len(data):
                if off + _FRAME.size > len(data):
                    torn += 1
                    self._truncate(spath, name, off, len(data))
                    break
                ln, crc = _FRAME.unpack_from(data, off)
                end = off + _FRAME.size + ln
                if ln > _MAX_RECORD or end > len(data):
                    # unparseable frame: everything from here is a
                    # partial write — the torn tail
                    torn += 1
                    self._truncate(spath, name, off, len(data))
                    break
                payload = data[off + _FRAME.size: end]
                off = end
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    corrupt += 1
                    continue  # framed but damaged: skip this record
                try:
                    rec = json.loads(payload)
                except ValueError:
                    corrupt += 1
                    continue
                nrecords += 1
                t = rec.get("t")
                if t == "H":
                    generations += 1
                    seeds.append(rec.get("seed"))
                    continue
                rids = _record_rids(rec)
                touched.update(rids)
                if t == "A":
                    k = _key(rec["rid"])
                    entries[k] = {
                        "rid": rec["rid"], "p": rec.get("p", []),
                        "sp": rec.get("sp", {}),
                        "out": list(rec.get("out", [])),
                        "ts": rec.get("ts"), "tn": rec.get("tn"),
                        "kv": rec.get("kv"), "fin": False,
                    }
                    order.setdefault(k, seq)
                    seq += 1
                elif t == "E":
                    for rid, toks in rec.get("e", []):
                        ent = entries.get(_key(rid))
                        if ent is not None and not ent["fin"]:
                            ent["out"].extend(toks)
                elif t in ("F", "X"):
                    ent = entries.get(_key(rec["rid"]))
                    if ent is not None:
                        ent["fin"] = True
                elif t == "R":
                    epoch_max = max(epoch_max, rec.get("ep", 0))
                    op = rec.get("op", "")
                    rep = rec.get("rep")
                    if op.endswith("-begin"):
                        open_ops[(op[:-6], rep)] = rec.get("ep", 0)
                    elif op.endswith("-end"):
                        open_ops.pop((op[:-4], rep), None)
        self.generation = generations + 1
        if self.seed is not None and any(
            s is not None and s != self.seed for s in seeds
        ):
            self.seed_mismatches += 1
            warnings.warn(
                f"[journal] {self.path} was written under a different "
                f"engine seed ({[s for s in seeds if s is not None]} "
                f"vs {self.seed}): greedy replay is unaffected, but "
                "sampled continuations will draw a different key "
                "stream",
                stacklevel=2,
            )
        self._open = {
            k for k, ent in entries.items() if not ent["fin"]
        }
        unfinished = sorted(self._open, key=order.get)
        result = [
            ReplayEntry(
                entries[k]["rid"], entries[k]["p"], entries[k]["sp"],
                entries[k]["out"], entries[k]["ts"], entries[k]["tn"],
                entries[k]["kv"],
            )
            for k in unfinished
        ]
        _advance_request_counter(
            ent["rid"] for ent in entries.values()
        )
        if corrupt:
            self.corrupt_records += corrupt
            warnings.warn(
                f"[journal] {self.path}: skipped {corrupt} corrupt "
                "record(s) during replay",
                stacklevel=2,
            )
        if torn:
            self.torn_tails += torn
        self.replayed_requests += len(result)
        # epoch numbering resumes past the dead incarnation's max, and
        # any *-begin its crash left unclosed is surfaced (delivery
        # itself is already exactly-once via latest-ADMIT-wins)
        self._epoch = max(self._epoch, epoch_max)
        interrupted = sorted(
            f"{op}@{rep}" if rep is not None else op
            for op, rep in open_ops
        )
        self.replay_report = {
            "segments": len(self.segments()), "records": nrecords,
            "corrupt": corrupt, "torn": torn,
            "finished": sum(e["fin"] for e in entries.values()),
            "unfinished": len(result), "generation": self.generation,
            "epochs": epoch_max, "interrupted_ops": interrupted,
        }
        _flight_record("replay", path=self.path, **self.replay_report)
        # recovery appends go to a fresh headered segment: the dead
        # incarnation's files are never appended to again, so a torn
        # tail can only ever be the one replay just truncated. A
        # WRITER failure here (read-only dir, disk full) must not
        # throw away the recovery that just succeeded — the entries
        # are returned regardless and the append path degrades on its
        # own terms (flush retries _open_segment and warns + counts).
        try:
            self._open_segment()
            self._compact()
        except Exception as e:
            # the degradation contract:
            # a parse-clean recovery must survive an unwritable dir
            self.append_errors += 1
            warnings.warn(
                f"[journal] could not open a recovery segment in "
                f"{self.path} ({type(e).__name__}: {e}); recovered "
                f"{len(result)} request(s) anyway — the journal is "
                "lossy until the directory becomes writable",
                stacklevel=3,
            )
        return result

    def _truncate(self, spath, name, good, total):
        """Cut a segment back to its last whole record (the crash's
        partial write is unrecoverable by construction)."""
        warnings.warn(
            f"[journal] {name}: torn tail truncated at byte {good} "
            f"(dropping {total - good} partial byte(s))",
            stacklevel=3,
        )
        try:
            with open(spath, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            # unwritable journal dir: replay still proceeds off the
            # in-memory parse; the tail will be re-truncated next boot
            warnings.warn(
                f"[journal] could not truncate {name}: {e}",
                stacklevel=3,
            )


def _key(rid):
    """Journal-side request key: rids may be ints (engine default) or
    strings (caller-chosen ids); JSON round-trips both faithfully, and
    keys must compare the same way on both sides of a crash."""
    return rid if isinstance(rid, str) else int(rid)


def _record_rids(rec):
    t = rec.get("t")
    if t == "E":
        return {_key(rid) for rid, _ in rec.get("e", [])}
    if t in ("A", "F", "X"):
        return {_key(rec["rid"])}
    return set()


def _advance_request_counter(rids):
    """A fresh process restarts the module-level Request id counter at
    zero; replayed numeric rids would collide with new admissions
    (same id on two live requests breaks every rid-keyed map). Advance
    the shared counter past everything the journal has seen."""
    numeric = [r for r in rids if isinstance(r, int)]
    if not numeric:
        return
    from . import request as _request_mod

    current = next(_request_mod._request_counter)
    _request_mod._request_counter = itertools.count(
        max(current, max(numeric) + 1)
    )
