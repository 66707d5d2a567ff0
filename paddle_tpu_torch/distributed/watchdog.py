"""Communication watchdog: hang detection for a host-side span.

Counterpart of ``paddle_tpu/distributed/watchdog.py`` for one process.
The watchable unit is a host-side span (a whole train step, a checkpoint
barrier): ``watch(tag)`` registers a deadline with a background thread;
on expiry the watchdog dumps every Python thread's stack and its health
probes, records the trip in the flight recorder and dumps it, and then
calls ``on_timeout(tag, why)`` or, without one, interrupts the main
thread (the scope then raises ``CommTimeoutError``).

    wd = enable_comm_watchdog(timeout=300)
    with wd.watch("train.step"):
        step(batch)

The JAX package also propagates a trip to peer ranks through a TCPStore
(``store=``); the store is not ported, and ``store=`` raises.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback

__all__ = [
    "CommWatchdog", "enable_comm_watchdog", "disable_comm_watchdog",
    "get_comm_watchdog", "CommTimeoutError",
]

class CommTimeoutError(RuntimeError):
    pass


class CommWatchdog:
    def __init__(self, timeout=1800.0, store=None, rank=0,
                 poll_interval=1.0, on_timeout=None):
        if store is not None:
            raise NotImplementedError(
                "CommWatchdog(store=...): abort propagation through a "
                "TCPStore is not ported (no store in the port yet)"
            )
        self.timeout = float(timeout)
        self.rank = rank
        self._poll = poll_interval
        self._on_timeout = on_timeout
        self._active = {}      # id -> (tag, deadline)
        self._next = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.fired = None      # (tag, why) after a trip
        self._probes = {}      # name -> (probe fn, owner weakref|None)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- registration ------------------------------------------------------
    class _Scope:
        def __init__(self, wd, tag, timeout):
            self._wd = wd
            self._tag = tag
            self._timeout = timeout
            self._id = None

        def __enter__(self):
            self._id = self._wd._register(self._tag, self._timeout)
            return self

        def __exit__(self, *exc):
            # _clear returns the trip observed ATOMICALLY with the
            # deregistration: another thread's _register may re-arm
            # (fired=None) the instant our registration leaves _active
            fired = self._wd._clear(self._id)
            if exc[0] is None and fired is not None:
                tag, why = fired
                raise CommTimeoutError(
                    f"communication watchdog fired during {tag!r}: {why}"
                )
            return False

    def watch(self, tag, timeout=None):
        return self._Scope(self, tag, timeout or self.timeout)

    def register_probe(self, name, fn, owner=None):
        """Attach a health probe (e.g. ``serving.Engine.health``); its
        snapshot is dumped next to the thread stacks when the watchdog
        trips, so a hang report carries subsystem state. Probes are
        only INVOKED at trip time (they may touch wedged subsystems);
        one that returns None — its target was garbage-collected — is
        pruned by the trip dump. Register through a weakref closure so
        a dead target costs a dict entry, not its object graph.

        ``owner``: the probed object; held by weakref so registration
        and trips can prune dead probes WITHOUT invoking them (an
        invoke-to-check would defeat the only-at-trip-time rule).
        Long-lived processes churn through probed objects (serving
        engines per test/deploy), so dead entries are dropped every
        time a new probe registers."""
        import weakref

        ref = None
        if owner is not None:
            try:
                ref = weakref.ref(owner)
            except TypeError:
                ref = None  # unweakrefable owner: keep the probe forever
        self._prune_probes()
        self._probes[name] = (fn, ref)

    def unregister_probe(self, name):
        """Drop a probe; returns True if it was registered."""
        return self._probes.pop(name, None) is not None

    def _prune_probes(self):
        for name, (fn, ref) in list(self._probes.items()):
            if ref is not None and ref() is None:
                self._probes.pop(name, None)

    def _register(self, tag, timeout):
        with self._lock:
            # a trip is one-shot for the scopes that observed it (they
            # raise at exit); the FIRST scope opened after all of those
            # drained re-arms the watchdog. The monitor thread exits
            # after a trip, so always start a fresh one (the old one may
            # still be finishing its stack dump — it returns on its own).
            if self.fired is not None and not self._active:
                self.fired = None
                self._thread = threading.Thread(
                    target=self._loop, daemon=True
                )
                self._thread.start()
            wid = self._next
            self._next += 1
            self._active[wid] = (tag, time.time() + timeout)
            return wid

    def _clear(self, wid):
        with self._lock:
            self._active.pop(wid, None)
            return self.fired

    # -- the background loop ----------------------------------------------
    def _loop(self):
        while not self._stop.wait(self._poll):
            now = time.time()
            expired = None
            with self._lock:
                for tag, deadline in self._active.values():
                    if now > deadline:
                        expired = (tag, "local timeout")
                        break
            if expired is not None:
                self._trip(*expired)
                return

    def _trip(self, tag, why):
        self.fired = (tag, why)
        sys.stderr.write(
            f"[comm_watchdog] rank {self.rank}: {tag!r} {why} "
            f"(timeout={self.timeout}s) — thread stacks:\n"
        )
        for tid, frame in sys._current_frames().items():
            sys.stderr.write(f"--- thread {tid} ---\n")
            sys.stderr.write("".join(traceback.format_stack(frame)))
        self._prune_probes()
        probe_snaps = {}
        for name, (probe, _ref) in list(self._probes.items()):
            try:
                snap = probe()
                if snap is None:  # probe target was garbage-collected
                    self._probes.pop(name, None)
                    continue
                probe_snaps[name] = snap
                sys.stderr.write(f"--- probe {name}: {snap!r}\n")
            except Exception as e:  # a broken probe must not mask the trip
                probe_snaps[name] = {"error": repr(e)}
                sys.stderr.write(f"--- probe {name} failed: {e!r}\n")
        # postmortem: the flight recorder captures what led UP to the
        # hang next to the probe snapshots; dump degrades its own
        # failures
        try:
            from ..observability import flight

            flight.record(
                "watchdog", "trip", tag=tag, why=why, rank=self.rank,
            )
            flight.dump(f"watchdog-trip:{tag}", probes=probe_snaps)
        except Exception as e:  # never mask the trip itself
            sys.stderr.write(f"--- flight dump failed: {e!r}\n")
        if self._on_timeout is not None:
            self._on_timeout(tag, why)
        else:
            import _thread

            _thread.interrupt_main()

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=2)


_singleton: CommWatchdog | None = None


def enable_comm_watchdog(timeout=1800.0, store=None, rank=0, **kw):
    """Install the process-wide watchdog (``get_comm_watchdog`` returns
    it), shutting down the one installed before."""
    global _singleton
    if _singleton is not None:
        _singleton.shutdown()
    _singleton = CommWatchdog(timeout=timeout, store=store, rank=rank, **kw)
    return _singleton


def disable_comm_watchdog():
    global _singleton
    if _singleton is not None:
        _singleton.shutdown()
        _singleton = None


def get_comm_watchdog():
    return _singleton
