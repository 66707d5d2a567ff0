"""Replica supervision for the serving fleet (counterpart of
``paddle_tpu/serving/supervisor.py``).

One ``ReplicaSupervisor`` owns one ``Engine`` replica's lifecycle on
behalf of ``serving.fleet.Fleet``:

  * **spawn** — synchronous first launch. The JAX package gates the
    replica's decode step through ``Engine.check_decode`` first; that
    analyzer is not ported yet, so the port takes ``analysis_check=None``
    only and refuses any other value by name.
  * **supervised stepping** — :meth:`step` fires the ``serving.replica``
    fault site (``phase="step"``) and forwards to ``Engine.step``; any
    exception that escapes is a replica death the fleet turns into a
    failover (the fleet re-raises a device fault instead: see
    ``serving.fleet``).
  * **quarantine + background restart** — after a death the fleet calls
    :meth:`quarantine` (the broken engine is dropped so its KV pool and
    graphs can be reclaimed) and :meth:`start_restart`, which rebuilds
    the engine on a daemon thread under a ``resilience.RetryPolicy``. On
    the card the rebuild's device setup takes ``programs.capture_lock``,
    so it never overlaps another replica's capture. Each crash restart
    spends one unit of the ``max_restarts`` budget; exhausting the
    budget — or the retry policy within one restart — marks the replica
    permanently ``"failed"`` and the fleet shrinks around it. A device
    fault (``torch.AcceleratorError``) in a rebuild is not retried: a
    CUDA error is sticky for the process, so :meth:`poll` re-raises it
    on the stepping thread.

States: ``offline`` → ``healthy`` ⇄ ``draining``; ``healthy`` →
``quarantined`` (dead, restart pending/in flight) → ``healthy`` or
``failed`` (terminal).

Every spawn/restart attempt fires ``serving.replica`` with
``phase="spawn"``/``"restart"``, so tests schedule replica crashes and
restart failures like any other fault.
"""
from __future__ import annotations

import threading

from ..resilience import faults
from ..resilience.retry import RetryPolicy
from .engine import _DEVICE_FAULTS

__all__ = ["ReplicaSupervisor"]


def check_analysis(analysis_check):
    """The spawn gate's setting: only None (no gate) until the analyzer
    (``Engine.check_decode``) is ported."""
    if analysis_check is not None:
        raise NotImplementedError(
            f"analysis_check={analysis_check!r} needs the static analyzer "
            "(Engine.check_decode), which paddle_tpu_torch does not port "
            "yet; pass analysis_check=None"
        )


class _DeviceFaultInRestart(BaseException):
    """Carries a device fault out of the restart policy's loop, which
    retries every ``Exception``: no attempt follows a CUDA error."""


class ReplicaSupervisor:
    def __init__(self, name, factory, restart_policy=None, max_restarts=2,
                 analysis_check=None):
        check_analysis(analysis_check)
        self.name = name
        self._factory = factory
        # restart attempts retry ANY exception: an engine build failure
        # has no transient/permanent signature the supervisor could
        # classify, and the restart budget bounds the total damage
        self.restart_policy = restart_policy or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.5,
            retry_on=(Exception,), seed=0,
        )
        self.max_restarts = int(max_restarts)
        self.analysis_check = analysis_check
        self.engine = None
        self.status = "offline"
        self.restarts = 0          # crash restarts consumed (budget)
        self.last_error = None
        self._lock = threading.Lock()
        self._restart_thread = None
        self._pending_engine = None
        self._restart_error = None
        # errored+timeout counter watermark for routable(): the engine's
        # "degraded" flag is cumulative (those counters never reset), so
        # admission gates on NEW errors since the last observe_errors()
        # sweep — one expired request must not unroute a replica forever
        self._seen_errors = 0
        self._fresh_degraded = False

    def __repr__(self):
        return (
            f"ReplicaSupervisor({self.name!r}, status={self.status!r}, "
            f"restarts={self.restarts}/{self.max_restarts})"
        )

    # -- build / spawn -------------------------------------------------------
    def _build(self, phase):
        faults.fire("serving.replica", replica=self.name, phase=phase)
        return self._factory()

    def _rebuild(self):
        try:
            return self._build("restart")
        except _DEVICE_FAULTS as e:
            raise _DeviceFaultInRestart(e) from e

    def spawn(self):
        """Synchronous first launch (fleet construction / rolling
        restart)."""
        self.engine = self._build("spawn")
        self.status = "healthy"
        self._seen_errors = 0
        self._fresh_degraded = False
        return self.engine

    # -- serving -------------------------------------------------------------
    def step(self):
        """One supervised engine step; exceptions escape to the fleet's
        death handler. ``serving.replica``/``phase="step"`` is the
        deterministic kill site: it fires BEFORE the engine step, so an
        injected death always lands on a step boundary where the KV
        invariant (``num_cached`` = prompt + output[:-1]) holds — the
        state re-prefill recovery depends on."""
        faults.fire("serving.replica", replica=self.name, phase="step")
        return self.engine.step()

    def health(self):
        """The engine's health snapshot, or None when there is no live
        engine (quarantined/failed/offline)."""
        eng = self.engine
        if eng is None:
            return None
        try:
            return eng.health()
        except Exception:
            # a replica whose health probe raises is unroutable, not a
            # fleet crash
            return None

    def observe_errors(self):
        """Advance the error watermark — called by the fleet ONCE per
        scheduler step, and nowhere else, so read paths (health scrapes,
        ``Fleet.health()``, repeated ``_pick_replica`` calls within one
        step) never consume the one-step "fresh degraded" admission
        gate."""
        eng = self.engine
        if eng is None:
            self._fresh_degraded = False
            return
        m = eng.metrics
        errors = m.requests_errored + m.requests_timeout
        self._fresh_degraded = errors > self._seen_errors
        self._seen_errors = errors

    def routable(self):
        """May this replica receive NEW requests? Healthy status AND a
        clean health snapshot: the ``overloaded`` flag, a tripped comm
        watchdog, or a fresh ``degraded`` signal (new poisoned/expired
        requests since the previous :meth:`observe_errors` sweep) stops
        admission. Read-only: safe from any thread."""
        if self.status != "healthy" or self.engine is None:
            return False
        h = self.health()
        if h is None:
            return False
        if "overloaded" in h.get("flags", ()) or h["watchdog"]["fired"]:
            return False
        return not self._fresh_degraded

    def load(self):
        """Routing load: queued + running requests (least-loaded
        admission key)."""
        eng = self.engine
        if eng is None:
            return float("inf")
        return len(eng.waiting) + sum(r is not None for r in eng.slots)

    # -- death / restart -----------------------------------------------------
    def quarantine(self, exc):
        """Mark the replica dead and drop the broken engine (the fleet
        re-enqueues its in-flight requests FIRST — see
        ``Fleet._on_replica_death``)."""
        self.last_error = f"{type(exc).__name__}: {exc}"
        self.engine = None
        self.status = "quarantined"

    def start_restart(self):
        """Kick off a background rebuild under the retry policy. Returns
        False — and flips to ``"failed"`` — when the restart budget is
        already spent."""
        if self.restarts >= self.max_restarts:
            self.status = "failed"
            return False
        self.restarts += 1

        def run():
            try:
                engine = self.restart_policy.call(self._rebuild)
            except _DeviceFaultInRestart as stop:
                with self._lock:
                    self._restart_error = stop.args[0]
                return
            except Exception as e:
                # the restart thread's only job is to report: ANY failure
                # past the retry policy means this replica is done
                with self._lock:
                    self._restart_error = e
                return
            with self._lock:
                self._pending_engine = engine

        self._restart_thread = threading.Thread(
            target=run, name=f"fleet-restart-{self.name}", daemon=True
        )
        self._restart_thread.start()
        return True

    def poll(self):
        """Adopt a finished background restart. Returns "recovered",
        "failed", or None (still restarting / nothing pending); a device
        fault from the rebuild raises."""
        with self._lock:
            engine = self._pending_engine
            error = self._restart_error
            self._pending_engine = self._restart_error = None
        if engine is not None:
            self.engine = engine
            self.status = "healthy"
            self._seen_errors = 0
            self._fresh_degraded = False
            return "recovered"
        if error is not None:
            self.last_error = f"{type(error).__name__}: {error}"
            self.status = "failed"
            if isinstance(error, _DEVICE_FAULTS):
                raise error
            return "failed"
        return None

    def join_restart(self, timeout=None):
        """Wait for an in-flight background restart thread; returns True
        when no thread is still running. The result is adopted by the
        next :meth:`poll`."""
        t = self._restart_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()
