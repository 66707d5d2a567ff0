"""Deterministic fault-injection registry (counterpart of
``paddle_tpu/resilience/faults.py``, the same API and schedules).

Product code declares a site with one cheap call:

    from paddle_tpu_torch.resilience import faults
    faults.fire("journal.append", path=..., records=n)   # no-op when idle

Tests activate a seeded schedule with a context manager:

    spec = faults.FaultSpec(OSError("disk full"), at=3)
    with faults.inject({"journal.append": spec}) as inj:
        ...                                          # 3rd flush raises
    assert inj.fired["journal.append"] == 1

Sites the port fires (each serving failure degrades, none is fatal,
except an injected ``torch.AcceleratorError`` at a serving site: a CUDA
error is sticky for the process, so the engine re-raises it; the two
training sites fail the step or the save, which a resume recovers):

    serving.step       one engine prefill/decode/verify launch, fired on
                       the host before the staging copy and the replay
                       (context: phase= "prefill"/"decode"/"verify",
                       request_id= for a prefill, request_ids= of the
                       active subset for a batched launch): the engine
                       finishes the poison request with "error" and keeps
                       the rest of the batch
    serving.replica    one fleet replica lifecycle event (context:
                       replica=, phase= "spawn"/"restart"/"step") —
                       phase="step" fires before the engine step, so an
                       injected death lands on a step boundary where the
                       recompute-preemption KV invariant holds
    fleet.route        one fleet request placement attempt (context:
                       request_id=, replica=): the request stays pending
                       and is placed on a later fleet step
    fleet.scale        one fleet scale-down (context: fleet=, action=,
                       replica=, reason=): counted, the fleet stays as
                       it was
    journal.append     one request-journal flush (context: path=,
                       records=): the records are dropped, counted and
                       warned once; serving continues
    journal.replay     one request-journal replay at engine or fleet
                       build (context: path=): an empty recovery, warned
                       and counted
    obs.accesslog      one access-log line (context: path=, rid=): the
                       line is dropped, counted and warned once
    obs.export         one exporter call (context: what= "scrape"/
                       "healthz"/"flight"/"chrome_trace")
    obs.stepstats      one serving step-observatory sample (context:
                       engine=), fired at the step tail before the
                       sample folds — a crashing sampler warns once and
                       disables itself (the engine drops its StepStats;
                       the weakref collector view follows), never
                       perturbing the step that carried it
    kv.spill           one KV spill to the host tier (context: key=,
                       cls= "prefix"/"request", nbytes=) — the old
                       destructive path applies (the block is freed, the
                       request recomputes at resume; warned once,
                       ``spill_errors``)
    kv.restore         one KV fetch from the host tier (context: key=) —
                       the recompute path the spill replaced (warned
                       once, ``restore_errors``, no block leak)
    train.step         one ``TrainLoop`` step, fired before ``step_fn``
                       (context: step=) — an injected exception kills
                       the training process like a crash; the next
                       incarnation resumes from the last checkpoint
    ckpt.write         one checkpoint file write (context: file=
                       "data.npz"/"metadata.json", path=) — the save
                       fails, its temporary directory is removed and
                       ``latest`` stays on the previous checkpoint
    http.accept        one POST /v1/completions accept (context: path=,
                       client=): a structured 500 for that request
    http.stream        one SSE chunk write (context: rid=, seq=): that
                       stream is aborted, the others go on

A fired spec is counted in ``paddle_tpu_resilience_fault_fires_total
{site}`` and logged to the flight recorder. Schedules are deterministic:
``at``/``every`` count ``fire()`` calls per site per injector, and ``p``
draws from ``random.Random(f"{seed}:{site}")``.
"""
from __future__ import annotations

import random
import threading
import time

__all__ = ["FaultSpec", "FaultInjector", "inject", "fire", "is_active"]


class FaultSpec:
    """One fault schedule for one site.

    exc:    exception instance, class, or zero-arg factory raised on a
            matching occurrence (ignored when ``action`` is given).
    at:     1-indexed occurrence number(s) that fault; int or iterable.
    every:  fault every Nth occurrence (1 = every call).
    p:      probability a given occurrence faults (seeded, see module
            docstring). Exactly one of at/every/p should be set; with
            none set, EVERY occurrence faults.
    when:   optional predicate over the fire() context kwargs; a
            non-matching call neither counts nor faults.
    max_fires: stop injecting after this many faults (None = unbounded).
    delay:  sleep this many seconds before raising (latency injection).
    action: optional callable(context) run INSTEAD of raising (a
            test can stall a site this way).
    """

    def __init__(self, exc=OSError, at=None, every=None, p=None,
                 when=None, max_fires=None, delay=0.0, action=None):
        self.exc = exc
        if at is None:
            self.at = None
        else:
            self.at = frozenset(
                (at,) if isinstance(at, int) else tuple(at)
            )
        self.every = every
        self.p = p
        self.when = when
        self.max_fires = max_fires
        self.delay = float(delay)
        self.action = action
        if sum(x is not None for x in (self.at, every, p)) > 1:
            raise ValueError("set at most one of at/every/p")

    def _matches(self, count, rng):
        if self.at is not None:
            return count in self.at
        if self.every is not None:
            return count % self.every == 0
        if self.p is not None:
            return rng.random() < self.p
        return True

    def _raise(self, site, context):
        if self.delay:
            time.sleep(self.delay)
        if self.action is not None:
            self.action(context)
            return
        exc = self.exc
        if isinstance(exc, type) or callable(exc) and not isinstance(
            exc, BaseException
        ):
            exc = exc()
        if not isinstance(exc, BaseException):
            raise TypeError(f"FaultSpec.exc for {site!r} is not raisable")
        raise exc


class FaultInjector:
    """Context manager holding active specs + per-site accounting.

    ``hits[site]``  — fire() calls that matched the spec's ``when``
    ``fired[site]`` — faults actually injected
    """

    def __init__(self, specs, seed=0):
        self.specs = {
            site: list(sl) if isinstance(sl, (list, tuple)) else [sl]
            for site, sl in specs.items()
        }
        self.seed = seed
        self.hits: dict = {}
        self.fired: dict = {}
        self._counts: dict = {}
        self._nfired: dict = {}
        self._rngs: dict = {}
        self._lock = threading.Lock()

    def _rng(self, site):
        if site not in self._rngs:
            self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return self._rngs[site]

    def _fire(self, site, context):
        specs = self.specs.get(site)
        if not specs:
            return
        with self._lock:
            for i, spec in enumerate(specs):
                if spec.when is not None and not spec.when(context):
                    continue
                key = (site, i)
                self._counts[key] = count = self._counts.get(key, 0) + 1
                self.hits[site] = self.hits.get(site, 0) + 1
                if (spec.max_fires is not None
                        and self._nfired.get(key, 0) >= spec.max_fires):
                    continue
                if spec._matches(count, self._rng(site)):
                    self._nfired[key] = self._nfired.get(key, 0) + 1
                    self.fired[site] = self.fired.get(site, 0) + 1
                    break
            else:
                return
        _record_fire(site, context)
        # raise outside the lock: handlers may re-enter fire()
        spec._raise(site, context)

    def __enter__(self):
        _stack.append(self)
        return self

    def __exit__(self, *exc):
        try:
            _stack.remove(self)
        except ValueError:
            pass
        return False


def _record_fire(site, context):
    """Telemetry for an injected fault (counter + flight-recorder
    event). Lazy import: resilience loads before observability in the
    package graph. Telemetry must never break the injection itself."""
    try:
        from ..observability import flight, metrics

        metrics.counter(
            "paddle_tpu_resilience_fault_fires_total",
            "injected faults actually fired, by site", ("site",),
        ).inc(site=site)
        flight.record(
            "fault", site,
            **{k: repr(v) for k, v in context.items()},
        )
    except Exception:
        # telemetry is best-effort here;
        # the scheduled fault must still raise even if recording fails
        pass


# Active injectors, innermost last (plain module state, as in the JAX
# package: one schedule covers every thread of the process).
_stack: list = []


def inject(specs, seed=0):
    """``with faults.inject({"site": FaultSpec(...)}) as inj:`` —
    activate a schedule for the dynamic extent of the block."""
    return FaultInjector(specs, seed=seed)


def is_active():
    return bool(_stack)


def fire(site, **context):
    """Product-code fault point. Free when no injector is active; under
    an active schedule, raises/acts per the matching FaultSpec."""
    if not _stack:
        return
    for inj in reversed(_stack):
        inj._fire(site, context)
