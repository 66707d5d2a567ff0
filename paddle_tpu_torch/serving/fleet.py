"""Replicated, self-healing serving fleet (counterpart of
``paddle_tpu/serving/fleet.py``, without the placement plan and the
autoscaler, which wait for tensor parallelism).

One ``Engine`` is a single point of failure: an unhandled ``step()``
error kills every in-flight request with no recovery path, and there is
no way to reload weights without dropping traffic. ``Fleet`` owns N
supervised replicas (``supervisor.ReplicaSupervisor``) behind the same
``add_request``/``step``/``generate`` facade as a single engine and
layers the tail-tolerance playbook of Dean & Barroso's "The Tail at
Scale" over it:

  * **Health-gated, hit-aware, least-loaded routing** — a new request
    prefers the routable replica whose prefix cache holds the longest
    chain match for its prompt (``Engine.health()`` exports the cached
    chain digests), falling back to the live replica with the fewest
    queued+running requests (KV headroom breaks ties); a replica whose
    health reports ``overloaded``, or fresh poisoned or expired requests,
    stops receiving new work. Unroutable moments park requests in a
    fleet-level pending queue (``max_pending`` sheds past it, parked
    TTLs expire).
  * **Crash recovery** — a replica death (an unhandled step error or an
    injected ``serving.replica`` fault) is quarantined; every in-flight
    request is re-enqueued on a healthy replica through
    ``Engine.resume``, which re-prefills ``prompt + output[:-1]`` (the
    recompute-preemption path), so greedy outputs are the uninterrupted
    run's (token for token on the CPU; on the card bf16 re-prefill and
    decode may round apart after the failover). The dead replica
    restarts in the background under a ``resilience.RetryPolicy`` with
    a restart budget; exceeding it marks the replica permanently failed
    and the fleet shrinks. A device fault (``torch.AcceleratorError``)
    is not a replica death: a CUDA error is sticky for the whole process,
    every replica's context with it, so ``step`` re-raises it and the
    caller (the HTTP server's driver) stops.
  * **Hedged requests** — a request stuck past
    ``FleetConfig(hedge_after_s=...)`` is dispatched a second time on a
    different replica; the first completion wins and the loser is
    aborted.
  * **Rolling drain/restart** — ``drain(replica)`` stops admission and
    steps the fleet until the replica's in-flight work completes;
    ``rolling_restart(min_available=k, model=)`` cycles replicas through
    migrate → rebuild (weight reload) → rejoin without dropping
    requests (in-flight work moves off through ``Engine.release`` to the
    pending-queue head and re-places through ``resume``);
    ``scale_down`` releases one replica the same way. With the host
    spill tier on (``EngineConfig(host_spill_bytes=)``) a released
    request's KV is parked under a handle it carries, and the replica
    that resumes it in this process restores the blocks from the peer
    tier instead of re-prefilling; a failed-over request that was parked
    before its replica died restores the same way.
  * **Front-door journal** — ``FleetConfig(journal_dir=)`` write-ahead
    logs every admission and completion once for the whole fleet
    (``serving.journal``); a fleet built on the directory replays it
    after its replicas spawn, before any traffic.

On one card the replicas share the model's weights; each has its own KV
pool, staging buffers and CUDA graphs, and ``Fleet.step`` steps them one
after another on the calling thread. A background restart builds its
engine on another thread; its device setup and every capture take
``programs.capture_lock``, so the two never overlap.

Observability: a pull-time collector view exports ``paddle_tpu_fleet_*``
series (failovers, hedges won/lost, restarts, per-replica status), and
merged latency digests across replicas; route/failover/hedge run under
spans, and a replica death records ``fleet``/``failover`` events and
dumps a flight-recorder postmortem before the restart begins.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
import weakref

from ..observability import MetricFamily, get_registry
from ..observability import flight as _flight
from ..observability import (
    register_health_provider,
    span,
    unregister_health_provider,
)
from ..observability.latency import (
    LatencyDigest,
    SLOTracker,
    burn_from_counts,
    sustained_burn,
)
from ..observability.metrics import register_latency_view
from ..resilience import faults
from .access_log import record_finish
from .engine import (
    _DEVICE_FAULTS,
    Engine,
    EngineConfig,
    EngineOverloadedError,
)
from .prefix_cache import prompt_chain_digests
from .request import (
    Request,
    RequestOutput,
    RequestState,
    normalize_sampling_params,
)
from .spill import drop_handle
from .supervisor import ReplicaSupervisor

__all__ = ["Fleet", "FleetConfig", "FleetMetrics", "FleetRequest",
           "NoReplicaError"]


class NoReplicaError(RuntimeError):
    """Every replica has permanently failed: the fleet cannot serve."""


# monotonic fleet ids (same rationale as the engine counter: metric
# labels and collector names must never alias across fleet lifetimes)
_fleet_counter = itertools.count(1)


class FleetConfig:
    def __init__(self, num_replicas=2, hedge_after_s=None, max_restarts=2,
                 restart_policy=None, analysis_check="error",
                 max_pending=None, journal_dir=None, placement=None,
                 scaling=None):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}"
            )
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 or None (unbounded), got "
                f"{max_pending}"
            )
        if hedge_after_s is not None and hedge_after_s < 0:
            raise ValueError(
                f"hedge_after_s must be >= 0 or None (disabled), got "
                f"{hedge_after_s}"
            )
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}"
            )
        if analysis_check not in (None, "warn", "error"):
            raise ValueError(
                'analysis_check must be None, "warn" or "error", got '
                f"{analysis_check!r}"
            )
        for name, value in (("placement", placement), ("scaling", scaling)):
            if value is not None:
                raise NotImplementedError(
                    f"FleetConfig({name}=) waits for tensor parallelism "
                    "(serving/placement.py carves devices into per-replica "
                    "TP slices), which paddle_tpu_torch does not port yet; "
                    "on one card the replicas share the device"
                )
        self.num_replicas = int(num_replicas)
        # hedging deadline: None disables; 0.0 hedges any request not
        # finished by the step after its dispatch
        self.hedge_after_s = (
            None if hedge_after_s is None else float(hedge_after_s)
        )
        # crash-restart budget PER REPLICA (rolling restarts are
        # operator-initiated and do not spend it)
        self.max_restarts = int(max_restarts)
        self.restart_policy = restart_policy
        # decode-program gate each replica runs at spawn/restart
        # (Engine.check_decode, the JAX default "error"); None disables
        self.analysis_check = analysis_check
        # fleet admission bound: add_request raises
        # EngineOverloadedError (the engine's shedding semantics) once
        # this many requests are parked unroutable — an unplaceable
        # backlog must push back on clients, not grow without limit.
        # Failover re-enqueues and journal recovery bypass the bound:
        # recovered work is never shed.
        self.max_pending = (
            None if max_pending is None else int(max_pending)
        )
        # durable request journal (serving/journal.py): a directory
        # path or Journal shared by the WHOLE fleet at its front door.
        # A restarting fleet replays it before traffic.
        self.journal_dir = journal_dir


class FleetMetrics:
    """Fleet-level counters (host-side plain attributes, same contract
    as ``EngineMetrics``: the registry PULLS at scrape time through the
    fleet's collector view, nothing is written on the hot path)."""

    def __init__(self):
        self.requests_received = 0
        self.requests_finished = 0
        self.requests_shed = 0        # bounced off the max_pending bound
        self.requests_timeout = 0     # TTL-expired while parked pending
        self.journal_replayed = 0     # requests recovered from the WAL
        self.failovers = 0            # replica deaths recovered from
        self.failover_requests = 0    # in-flight requests re-enqueued
        self.hedges_started = 0
        self.hedges_won = 0           # hedge dispatch delivered the win
        self.hedges_lost = 0          # primary beat its hedge
        self.restarts = 0             # successful rebuilds (crash+rolling)
        self.replicas_failed = 0      # permanent failures (fleet shrank)
        self.route_errors = 0
        self.route_prefix_hits = 0    # placements won by prefix affinity
        self.scale_downs = 0          # replicas released
        self.scale_errors = 0         # degraded scale_down (fleet.scale)
        self.requests_migrated = 0    # in-flight moved off a departing replica
        # failover recovery timing (the bench [fleet] row): stamped at
        # death detection and at the first token a re-enqueued request
        # produces on its new replica
        self.last_failover_detect_s = None
        self.last_recovered_token_s = None

    @property
    def failover_recovery_s(self):
        """Kill-to-first-recovered-token of the most recent failover,
        or None."""
        if (self.last_failover_detect_s is None
                or self.last_recovered_token_s is None
                or self.last_recovered_token_s
                < self.last_failover_detect_s):
            return None
        return self.last_recovered_token_s - self.last_failover_detect_s


# counter attribute -> exported series name
_FLEET_COUNTERS = {
    "requests_received": "paddle_tpu_fleet_requests_received_total",
    "requests_finished": "paddle_tpu_fleet_requests_finished_total",
    "requests_shed": "paddle_tpu_fleet_requests_shed_total",
    "requests_timeout": "paddle_tpu_fleet_requests_timeout_total",
    "journal_replayed": "paddle_tpu_fleet_journal_replayed_total",
    "failovers": "paddle_tpu_fleet_failovers_total",
    "failover_requests": "paddle_tpu_fleet_failover_requests_total",
    "hedges_started": "paddle_tpu_fleet_hedges_started_total",
    "hedges_won": "paddle_tpu_fleet_hedges_won_total",
    "hedges_lost": "paddle_tpu_fleet_hedges_lost_total",
    "restarts": "paddle_tpu_fleet_restarts_total",
    "replicas_failed": "paddle_tpu_fleet_replicas_failed_total",
    "route_errors": "paddle_tpu_fleet_route_errors_total",
    "route_prefix_hits": "paddle_tpu_fleet_route_prefix_hits_total",
    "scale_downs": "paddle_tpu_fleet_scale_downs_total",
    "scale_errors": "paddle_tpu_fleet_scale_errors_total",
    "requests_migrated": "paddle_tpu_fleet_requests_migrated_total",
}

# supervisor status -> the lifecycle state exported on the
# paddle_tpu_fleet_replicas{state=} gauge (scale events read as edges:
# spawning -> live on a restart, draining -> released on scale-down)
_REPLICA_STATES = ("spawning", "live", "draining", "released", "failed")
_STATUS_TO_STATE = {
    "offline": "spawning", "quarantined": "spawning",
    "healthy": "live", "draining": "draining",
    "released": "released", "failed": "failed",
}


def _register_view(fleet):
    """Pull-time collector over one fleet (weakref: a collected fleet's
    view unregisters itself, mirroring EngineMetrics)."""
    ref = weakref.ref(fleet)
    name = f"serving.fleet.{fleet.fleet_id}"

    def latency_view():
        fl = ref()
        return None if fl is None else fl.merged_latency()

    # replica digests merged AT PULL TIME (merge == pooled, so the
    # fleet-labeled paddle_tpu_serving_latency_seconds series is
    # exactly what one engine serving all the traffic would export)
    register_latency_view(
        f"serving.fleet.latency.{fleet.fleet_id}", latency_view,
        "paddle_tpu_serving_latency", labels={"fleet": fleet.fleet_id},
    )

    def collect():
        fl = ref()
        if fl is None:
            return None
        label = {"fleet": fl.fleet_id}
        m = fl.metrics
        fams = [
            MetricFamily(series, "counter").add(getattr(m, attr), label)
            for attr, series in _FLEET_COUNTERS.items()
        ]
        fams.append(MetricFamily(
            "paddle_tpu_fleet_replicas_total", "gauge",
        ).add(fl.size(), label))
        fams.append(MetricFamily(
            "paddle_tpu_fleet_replicas_healthy", "gauge",
        ).add(
            sum(s.status == "healthy" for s in fl.replicas), label,
        ))
        fams.append(MetricFamily(
            "paddle_tpu_fleet_pending_requests", "gauge",
        ).add(len(fl._pending), label))
        up = MetricFamily("paddle_tpu_fleet_replica_healthy", "gauge")
        restarts = MetricFamily(
            "paddle_tpu_fleet_replica_restarts_total", "counter",
        )
        # per-replica KV/prefix-cache economics: hit tokens saved,
        # computed prefill tokens, and reclaimable (cached, idle)
        # blocks — the router-facing split of pool pressure
        pfx_hits = MetricFamily(
            "paddle_tpu_fleet_replica_prefix_hits_total", "counter",
        )
        pfx_tokens = MetricFamily(
            "paddle_tpu_fleet_replica_prefix_hit_tokens_total",
            "counter",
        )
        pfill = MetricFamily(
            "paddle_tpu_fleet_replica_prefill_tokens_total", "counter",
        )
        reclaimable = MetricFamily(
            "paddle_tpu_fleet_replica_kv_reclaimable_blocks", "gauge",
        )
        # absorbable capacity per replica (free + reclaimable blocks):
        # the headroom-aware router's input, exported so a capacity
        # review can see WHY requests routed where they did
        headroom = MetricFamily(
            "paddle_tpu_fleet_replica_kv_headroom_blocks", "gauge",
        )
        # host spill tier per replica (serving/spill.py): occupancy and
        # restore hit rate, so a fleet review sees which replicas
        # survive pressure by swapping instead of recomputing
        spill_bytes = MetricFamily(
            "paddle_tpu_fleet_replica_spill_host_bytes", "gauge",
        )
        spill_hit = MetricFamily(
            "paddle_tpu_fleet_replica_spill_restore_hit_rate", "gauge",
        )
        for sup in fl.replicas:
            rl = {**label, "replica": sup.name}
            up.add(1.0 if sup.status == "healthy" else 0.0, rl)
            restarts.add(sup.restarts, rl)
            eng = sup.engine
            if eng is not None:
                em = eng.metrics
                pfx_hits.add(em.prefix_hits, rl)
                pfx_tokens.add(em.prefix_hit_tokens, rl)
                pfill.add(em.prefill_tokens, rl)
                reclaimable.add(em.kv_reclaimable_blocks, rl)
                headroom.add(em.kv_headroom_blocks, rl)
                tier = getattr(eng, "spill", None)
                if tier is not None:
                    ts = tier.stats()
                    spill_bytes.add(ts["host_bytes"], rl)
                    if ts["restore_hit_rate"] is not None:
                        spill_hit.add(ts["restore_hit_rate"], rl)
        fams += [
            up, restarts, pfx_hits, pfx_tokens, pfill, reclaimable,
            headroom,
        ]
        if spill_bytes.samples:
            fams.append(spill_bytes)
        if spill_hit.samples:
            fams.append(spill_hit)
        # replica lifecycle states, zero-filled over every state so a
        # scale event is a visible edge (0->1 spawning, 1->0 live, ...)
        # even on a fleet that has never scaled; released replicas are
        # the retired ring (bounded), not fl.replicas
        states = MetricFamily("paddle_tpu_fleet_replicas", "gauge")
        counts = dict.fromkeys(_REPLICA_STATES, 0)
        for sup in fl.replicas:
            counts[_STATUS_TO_STATE.get(sup.status, "live")] += 1
        counts["released"] += len(fl._retired)
        for st in _REPLICA_STATES:
            states.add(counts[st], {**label, "state": st})
        fams.append(states)
        cfg, pooled = fl._slo_pool()
        if cfg is not None:
            # fleet-level burn from POOLED windows (the per-replica
            # math over summed counts — a replica serving 10x the
            # traffic weighs 10x, which per-replica averaging loses);
            # one pool walk feeds both gauges
            burn = MetricFamily("paddle_tpu_fleet_slo_burn_rate",
                                "gauge")
            for sig, v in sorted(burn_from_counts(pooled, cfg).items()):
                if v is not None:
                    burn.add(v, {**label, "signal": sig})
            if burn.samples:
                fams.append(burn)
            fams.append(MetricFamily(
                "paddle_tpu_fleet_slo_burning", "gauge",
            ).add(1.0 if sustained_burn(pooled, cfg) else 0.0, label))
        return fams

    get_registry().register_collector(name, collect)


def _merge_digests(dst, src):
    """Fold a phase→LatencyDigest dict into another (merge-or-copy per
    phase) — the ONE merge semantic behind both the pull-time
    ``merged_latency`` view and the death-time ``_absorb_latency``
    fold, so the two can never diverge."""
    for phase, d in src.items():
        if phase in dst:
            dst[phase].merge(d)
        else:
            dst[phase] = d.copy()


class _Dispatch:
    """One placement of a request on one replica."""

    __slots__ = (
        "fleet_req", "request", "replica", "kind", "time", "cancelled",
        "finished",
    )

    def __init__(self, fleet_req, request, replica, kind):
        self.fleet_req = fleet_req
        self.request = request      # the engine-side Request object
        self.replica = replica      # replica NAME (survives restarts)
        self.kind = kind            # "primary" | "hedge"
        self.time = time.perf_counter()
        self.cancelled = False      # we aborted it (hedge loser)
        self.finished = False       # its engine emitted an output


class FleetRequest:
    """Client-facing handle for one fleet request. The underlying
    engine ``Request`` object travels with it across replicas
    (failover re-submits the SAME object, tokens intact)."""

    def __init__(self, prompt_token_ids, sampling_params, request_id):
        self.request = Request(
            prompt_token_ids, sampling_params, request_id
        )
        self.dispatches: list = []
        self.hedged = False
        self.done = False
        self.output = None
        self._chain_digests: dict = {}   # page_size -> prompt digests

    def chain_digests(self, block_size):
        """This prompt's chain digests at ``block_size`` granularity,
        hashed once per request lifetime (the hit-aware router matches
        them against replicas every sweep the request stays parked)."""
        d = self._chain_digests.get(block_size)
        if d is None:
            d = self._chain_digests[block_size] = prompt_chain_digests(
                self.prompt_token_ids, block_size
            )
        return d

    @property
    def request_id(self):
        return self.request.request_id

    @property
    def prompt_token_ids(self):
        return self.request.prompt_token_ids

    @property
    def sampling_params(self):
        return self.request.sampling_params

    def __repr__(self):
        return (
            f"FleetRequest(id={self.request_id}, done={self.done}, "
            f"dispatches={len(self.dispatches)})"
        )


class Fleet:
    """N supervised Engine replicas behind one engine-shaped facade.

        fleet = serving.Fleet(model, serving.EngineConfig(...),
                              serving.FleetConfig(num_replicas=2))
        outs = fleet.generate(prompts, serving.SamplingParams(...))

    or stream it like an engine::

        fleet.add_request(ids, params)
        while fleet.has_unfinished():
            for out in fleet.step():
                handle(out)
    """

    def __init__(self, model, engine_config=None, config=None):
        self.config = config or FleetConfig()
        self.engine_config = engine_config
        if (engine_config is not None
                and getattr(engine_config, "journal", None) is not None):
            raise ValueError(
                "EngineConfig(journal=) under a Fleet would make every "
                "replica replay — and double-admit — the same journal; "
                "use FleetConfig(journal_dir=) so the fleet journals "
                "once at its front door"
            )
        self._model = model
        self.fleet_id = f"{next(_fleet_counter)}"
        self.metrics = FleetMetrics()
        # fleet-local observability for requests that finish WITHOUT
        # reaching an engine (parked timeout, pending abort,
        # unplaceable): the overload tail is exactly what must not
        # vanish from the digests/SLO/access log, so _finish_local
        # records here and merged_latency()/_slo_pool() fold it in
        self._local_latency = {
            p: LatencyDigest() for p in ("queue", "ttft", "tpot", "e2e")
        }
        # makes absorb-and-drop atomic against a concurrent scrape's
        # merged_latency(): a dying replica's samples must move from
        # its engine digests to the fleet-local set in ONE observable
        # step, or the merged _count double-counts (or dips — either
        # reads as a counter reset to Prometheus) mid-failover
        self._latency_lock = threading.Lock()
        self._local_slo = None
        self._access_log = None
        if engine_config is not None:
            if engine_config.slo is not None:
                self._local_slo = SLOTracker(engine_config.slo)
            if engine_config.access_log is not None:
                from .access_log import resolve_access_log

                self._access_log = resolve_access_log(
                    engine_config.access_log
                )
        self.replicas: list = []
        for i in range(self.config.num_replicas):
            sup = self._make_supervisor(f"r{i}")
            sup.spawn()
            self.replicas.append(sup)
        # released supervisors (scale-down), kept for the state gauge
        # and introspection; bounded so a long-lived fleet cannot grow it
        # without limit
        self._retired: list = []
        self._pending: collections.deque = collections.deque()
        # optional multi-tenant QoS (serving/qos.py): when attached,
        # the dispatch sweep replaces FIFO with weighted fair-share
        # selection and completions feed per-tenant accounting
        self.qos = None
        self._routes: dict = {}     # engine request id -> _Dispatch
        self._ready: list = []      # finished client outputs, buffered
        self._req_counter = itertools.count()
        # (Request, n_tokens_at_failover) pairs awaiting their first
        # post-failover token — the recovery-time probe
        self._recovering: list = []
        # durable request journal at the fleet front door: replayed
        # AFTER the replicas spawn (a shared compile cache has already
        # warmed their programs — recovery re-prefills are zero-trace)
        # and BEFORE any traffic is accepted
        self.journal = None
        if self.config.journal_dir is not None:
            from .journal import resolve_journal

            seed = (
                engine_config.seed if engine_config is not None else 0
            )
            self.journal = resolve_journal(
                self.config.journal_dir, seed=seed
            )
            self._replay_journal()
        _register_view(self)

        def _probe(ref=weakref.ref(self)):
            fl = ref()
            return None if fl is None else fl.health()

        probe_name = f"serving.fleet.{self.fleet_id}"
        register_health_provider(probe_name, _probe)
        weakref.finalize(self, unregister_health_provider, probe_name)

    def _make_supervisor(self, name):
        cfg = self.config
        # the factory closes over the fleet (not a model snapshot) so
        # rolling_restart(model=...) reloads weights on rebuild
        return ReplicaSupervisor(
            name,
            factory=lambda: Engine(self._model, self.engine_config),
            restart_policy=cfg.restart_policy,
            max_restarts=cfg.max_restarts,
            analysis_check=cfg.analysis_check,
        )

    # -- durable request journal ---------------------------------------------
    def _replay_journal(self):
        """Crash recovery at the fleet front door: unfinished journal
        entries become FleetRequests at the HEAD of the pending queue
        (oldest first), tokens intact — dispatch places them through
        the resume() re-prefill path, so greedy continuations are
        byte-identical and no journaled token is re-emitted. TTLs that
        lapsed while the fleet was down retire as ``"timeout"``
        without touching a replica. Recovered work bypasses
        ``max_pending``: bounded admission must never drop requests
        the fleet already accepted."""
        entries = self.journal.replay()
        report = self.journal.replay_report or {}
        if report.get("interrupted_ops"):
            # a scaling op's *-begin with no *-end: the crash landed
            # mid-shrink/mid-restart. Delivery is still exactly-once
            # (the migration re-ADMITs won the latest-ADMIT-wins fold
            # before the epoch bracket closed) — surfaced here so the
            # postmortem shows WHICH op was cut short
            _flight.record(
                "fleet", "scale-interrupted", fleet=self.fleet_id,
                ops=report["interrupted_ops"],
            )
        # fleet rids are "fleet<id>-<n>": a fresh process restarts the
        # counter at 0, which would collide new rids with replayed
        # ones — advance past every journaled suffix
        mx = -1
        prefix = f"fleet{self.fleet_id}-"
        for e in entries:
            if isinstance(e.rid, str) and e.rid.startswith(prefix):
                tail = e.rid[len(prefix):]
                if tail.isdigit():
                    mx = max(mx, int(tail))
        if mx >= 0:
            self._req_counter = itertools.count(mx + 1)
        from .journal import restore_entries

        live, expired = restore_entries(
            self.journal, entries,
            lambda e, params: FleetRequest(e.prompt, params, e.rid),
        )
        self.metrics.requests_timeout += expired
        for freq in live:  # re-ADMIT in order, emit cursor carried
            self.journal.admit(freq.request)
        self.journal.flush()
        self._pending.extendleft(reversed(live))
        self.metrics.journal_replayed += len(live)
        self.metrics.requests_received += len(live)
        if entries:
            _flight.record(
                "fleet", "journal-recovered", fleet=self.fleet_id,
                requests=len(live), expired=len(entries) - len(live),
            )

    # -- introspection -------------------------------------------------------
    def replica(self, name):
        for sup in self.replicas:
            if sup.name == name:
                return sup
        raise KeyError(f"no replica {name!r} in fleet {self.fleet_id}")

    def size(self):
        """Live (non-permanently-failed) replica count."""
        return sum(s.status != "failed" for s in self.replicas)

    def has_unfinished(self):
        return bool(self._pending) or bool(self._routes) or bool(
            self._ready
        ) or any(
            s.engine is not None and s.engine.has_unfinished()
            for s in self.replicas
        )

    def health(self):
        """Fleet health snapshot (scrape /healthz provider): "ok" while
        at least one replica is routable, "degraded" while live-but-
        unroutable replicas remain (or the POOLED SLO window is
        burning — replicas can each sit under the per-replica sample
        floor while the fleet as a whole blows the objective),
        "failed" when the fleet is gone."""
        statuses = {s.name: s.status for s in self.replicas}
        routable = sum(s.routable() for s in self.replicas)
        # ONE pool walk per probe: burning and the rates derive from
        # the same counts (each _slo_pool takes every tracker's lock)
        cfg, pooled = self._slo_pool()
        burning = cfg is not None and sustained_burn(pooled, cfg)
        if not self.size():
            status = "failed"
        elif routable and not burning:
            status = "ok"
        else:
            status = "degraded"
        out = {
            "status": status,
            "replicas": statuses,
            "routable": routable,
            "pending": len(self._pending),
            "in_flight": len(self._routes),
            "slo_burn": burning,
            "slo_burn_rates": (
                burn_from_counts(pooled, cfg)
                if cfg is not None else None
            ),
        }
        return out

    def _absorb_latency(self, sup):
        """Fold a dying/rebuilding replica's cumulative latency digests
        into the fleet-local set and drop its engine, atomically with
        respect to ``merged_latency`` — the merged summary's
        _count/_sum must stay monotonic across failovers and rolling
        restarts (a concurrent scrape must never see the samples in
        both places, or in neither), and the killed replica's samples
        ARE the failover tail the merged view exists to keep. (The
        replica's short SLO window dies with it: burn is a now-signal
        and a dead replica is not serving.)"""
        with self._latency_lock:
            eng, sup.engine = sup.engine, None
            if eng is not None:
                _merge_digests(self._local_latency, eng.metrics.latency)
        return eng

    def merged_latency(self):
        """Per-phase latency digests merged across live replicas at
        call time — identical to one pooled digest by the merge
        invariant — seeded with the fleet-local samples (requests
        that finished without reaching an engine). The fleet-level
        percentile source (collector view, bench, operators via
        ``observability slo``)."""
        with self._latency_lock:
            # one consistent cut: local copies + the engine refs they
            # do NOT yet include (engine digests have their own locks;
            # merging outside ours is safe once the cut is taken)
            merged = {
                p: d.copy() for p, d in self._local_latency.items()
            }
            engines = [
                s.engine for s in self.replicas if s.engine is not None
            ]
        for eng in engines:
            _merge_digests(merged, eng.metrics.latency)
        return merged

    def _slo_pool(self):
        """``(config, pooled_window_counts)`` across replica SLO
        trackers (None config when no replica tracks an SLO). Pooling
        the raw window counts — not the per-replica burn rates —
        weighs each replica by its actual traffic."""
        cfg, pooled = None, {}
        trackers = [self._local_slo] if self._local_slo else []
        trackers += [
            sup.engine.slo for sup in self.replicas
            if sup.engine is not None and sup.engine.slo is not None
        ]
        for t in trackers:
            if cfg is None:
                cfg = t.config
            for k, v in t.window_counts().items():
                pooled[k] = pooled.get(k, 0) + v
        return cfg, pooled

    def slo_burn_rates(self):
        """Fleet-level burn per signal, or None without an SLO."""
        cfg, pooled = self._slo_pool()
        return burn_from_counts(pooled, cfg) if cfg is not None else None

    def slo_burning(self):
        """Sustained fleet-level burn: the per-engine predicate
        (``latency.sustained_burn``) over pooled counts."""
        cfg, pooled = self._slo_pool()
        return cfg is not None and sustained_burn(pooled, cfg)

    def snapshot(self):
        """Fleet counters + per-replica status, one JSON-friendly
        dict."""
        m = self.metrics
        out = {attr: getattr(m, attr) for attr in _FLEET_COUNTERS}
        out["replicas"] = {
            s.name: {"status": s.status, "restarts": s.restarts}
            for s in self.replicas
        }
        if self._retired:
            out["retired"] = [s.name for s in self._retired]
        out["pending"] = len(self._pending)
        return out

    def _live(self):
        return [s for s in self.replicas if s.status != "failed"]

    # -- client API ----------------------------------------------------------
    def add_request(self, prompt_token_ids, sampling_params=None,
                    request_id=None, tenant=None):
        if not self._live():
            raise NoReplicaError(
                f"fleet {self.fleet_id}: all replicas permanently failed"
            )
        cfg_f = self.config
        if (cfg_f.max_pending is not None
                and sum(not f.done for f in self._pending)
                >= cfg_f.max_pending):
            # counted over LIVE parked requests only: a done entry
            # still parked (its hedge won after the primary's replica
            # died; purged lazily at the queue head) is not backlog
            # bounded admission (the engine's shedding semantics at
            # fleet altitude): an unroutable backlog pushes back on
            # the client instead of growing without limit
            self.metrics.requests_shed += 1
            _flight.record(
                "fleet", "shed", fleet=self.fleet_id,
                pending=len(self._pending), tenant=tenant,
            )
            if self.qos is not None:
                self.qos.count_queue_shed(tenant)
            raise EngineOverloadedError(
                f"fleet {self.fleet_id} pending queue full "
                f"({cfg_f.max_pending} parked); request shed"
            )
        if request_id is None:
            request_id = f"fleet{self.fleet_id}-{next(self._req_counter)}"
        freq = FleetRequest(prompt_token_ids, sampling_params, request_id)
        # tenant set BEFORE the journal ADMIT below so the "tn" field
        # rides the WAL and replay restores the QoS accounting
        freq.request.tenant = tenant
        # surface the engine's admission error NOW, not on a later
        # dispatch attempt deep inside step(). Falls back to the fleet's
        # engine config while every replica is quarantined (engine is
        # None) so an over-long prompt can never park unvalidated.
        cfg = self.engine_config or EngineConfig()
        for sup in self._live():
            if sup.engine is not None:
                cfg = sup.engine.config
                break
        if len(freq.prompt_token_ids) >= cfg.max_model_len:
            raise ValueError(
                f"prompt of {len(freq.prompt_token_ids)} tokens "
                f"leaves no room to generate under "
                f"max_model_len={cfg.max_model_len}"
            )
        self.metrics.requests_received += 1
        self._pending.append(freq)
        if self.qos is not None:
            # admission-time accounting stamps the fair-queuing
            # virtual tags; parked requests age against later arrivals
            self.qos.on_admit(freq.request)
        if self.journal is not None:
            # WAL the admission before dispatch: once flushed, a crash
            # replays this request instead of losing it
            self.journal.admit(freq.request)
            self.journal.flush()
        self._dispatch_pending()
        return freq

    def abort(self, request_id):
        """Abort a fleet request wherever it is; returns True if
        found. A dispatched request finishes with
        ``finish_reason="aborted"`` through its replica's next step."""
        for freq in list(self._pending):
            if freq.request_id == request_id:
                self._pending.remove(freq)
                if freq.done:
                    # completed while parked (hedge won after its
                    # primary died): nothing left to abort
                    return False
                # a failover-requeued request may still carry a live
                # hedge dispatch: cancel it so it doesn't keep
                # decoding for a dead client, and close the hedge
                # accounting (resolution is local, not via _collect)
                for disp in freq.dispatches:
                    if disp.cancelled or disp.finished:
                        continue
                    disp.cancelled = True
                    sup = self._sup_or_none(disp.replica)
                    if sup is not None and sup.engine is not None:
                        sup.engine.abort(disp.request.request_id)
                if freq.hedged:
                    self.metrics.hedges_lost += 1
                self._finish_local(freq, "aborted")
                return True
        for d in list(self._routes.values()):
            if (d.fleet_req.request_id != request_id
                    or d.kind != "primary" or d.cancelled):
                continue
            freq = d.fleet_req
            if freq.done:
                return False
            # abort EVERY live dispatch — a hedge left running could
            # win the race against the abort and deliver a normal
            # completion. The primary is NOT marked cancelled (its
            # aborted output surfaces through _collect as this
            # request's completion); hedges are, so theirs is
            # swallowed.
            found = False
            for disp in freq.dispatches:
                if disp.cancelled or disp.finished:
                    continue
                sup = self._sup_or_none(disp.replica)
                if (sup is not None and sup.engine is not None
                        and sup.engine.abort(disp.request.request_id)):
                    found = True
                if disp.kind == "hedge":
                    disp.cancelled = True
            return found
        return False

    def _finish_local(self, freq, reason, error=None):
        """Finish a fleet request that never reached (or never
        returned from) an engine — pending abort, unplaceable — with
        the full completion accounting a routed request gets."""
        req = freq.request
        req.error = error
        req.finish_reason = reason
        req.state = RequestState.FINISHED
        req.finish_time = time.perf_counter()
        # a handle parked by a release on a replica will not be restored
        drop_handle(req)
        # close the timeline too (a request that timed out parked
        # still deserves a phase breakdown on RequestOutput.metrics),
        # then the SAME finish accounting an engine would do — local
        # digests (e2e at least; queue/ttft belong to whatever engine
        # life it had, which already recorded them), SLO window,
        # access-log line, flight ring — via the shared helper
        req.timeline.mark_finish(reason, req.finish_time)
        record_finish(
            req, latency=self._local_latency, slo=self._local_slo,
            access_log=self._access_log, fleet=self.fleet_id,
        )
        freq.done = True
        freq.output = RequestOutput(req)
        self.metrics.requests_finished += 1
        if self.qos is not None:
            self.qos.on_finish(req)
        if self.journal is not None:
            self.journal.finish(req, reason)
            self.journal.flush()
        self._ready.append(freq.output)

    def step(self):
        """One fleet scheduler iteration; returns finished client
        RequestOutputs (buffered outputs from internal stepping — a
        drain, a rolling restart — are delivered here too)."""
        self._step_once()
        out, self._ready = self._ready, []
        return out

    def generate(self, prompts, sampling_params=None):
        """Submit everything, step until done, return outputs in
        submission order (the Engine.generate contract, fleet-wide)."""
        params = normalize_sampling_params(prompts, sampling_params)
        reqs = [
            self.add_request(p, sp) for p, sp in zip(prompts, params)
        ]
        done = {}
        idle = 0
        while not all(r.done for r in reqs):
            if not self._live():
                raise NoReplicaError(
                    f"fleet {self.fleet_id}: all replicas failed with "
                    f"{sum(not r.done for r in reqs)} request(s) "
                    "unfinished"
                )
            before = len(done)
            for out in self.step():
                done[out.request_id] = out
            stepped = any(
                s.engine is not None and s.engine.has_unfinished()
                for s in self.replicas
            )
            idle = 0 if (len(done) > before or stepped) else idle + 1
            if idle > 2:
                if (idle > 50 and self._pending and not self._routes
                        and self._pick_replica() is None
                        and not any(s.status == "quarantined"
                                    for s in self.replicas)):
                    # nothing in flight, nothing restarting, and the
                    # pending work has no routable target (e.g. the
                    # only replica was drained and never resumed):
                    # no fleet state change can ever unstick this —
                    # diagnose instead of blocking forever
                    raise RuntimeError(
                        f"fleet {self.fleet_id}: {len(self._pending)} "
                        "request(s) cannot be placed — no routable "
                        "replica and no restart in flight (replicas: "
                        + ", ".join(
                            f"{s.name}={s.status}"
                            for s in self.replicas
                        ) + ")"
                    )
                # nothing to step and nothing finishing: wait out a
                # background restart instead of spinning
                time.sleep(0.005)
        # flush hedge losers: their aborts finish on the next step of
        # their replicas, and leaving them in flight would make a
        # drained fleet report unfinished work
        guard = 0
        while (self._routes
               and all(d.cancelled for d in self._routes.values())
               and guard < 100):
            for out in self.step():
                done[out.request_id] = out
            guard += 1
        if self._ready:
            # late bookkeeping (e.g. every request finished locally
            # before a step ran): harvest AND clear, or the next
            # step() would deliver these completions a second time
            for out in self._ready:
                done[out.request_id] = out
            self._ready = []
        return [done[r.request_id] for r in reqs]

    # -- drain / rolling restart ---------------------------------------------
    def drain(self, replica, max_steps=10000):
        """Stop admission to ``replica`` and step the fleet until its
        in-flight work completes (other replicas keep serving; their
        finished outputs are buffered for the next ``step()``)."""
        sup = self.replica(replica) if isinstance(replica, str) else replica
        if sup.status == "failed":
            return sup
        if sup.status == "healthy":
            sup.status = "draining"
        for _ in range(max_steps):
            if sup.engine is None or not sup.engine.has_unfinished():
                return sup
            self._step_once()
        raise RuntimeError(
            f"drain of replica {sup.name!r} did not converge in "
            f"{max_steps} steps"
        )

    def resume_replica(self, replica):
        """Re-admit a drained replica."""
        sup = self.replica(replica) if isinstance(replica, str) else replica
        if sup.status == "draining":
            sup.status = "healthy"
        return sup

    def rolling_restart(self, min_available=1, model=None):
        """Cycle every live replica through drain → rebuild → rejoin —
        weight reload without dropping requests. ``model`` (optional)
        replaces the weights used for every subsequent build. At least
        ``min_available`` replicas stay admitting throughout; rolling
        rebuilds are operator-initiated and do NOT spend the crash
        restart budget."""
        live = self._live()
        if not 0 <= min_available <= len(live) - 1:
            raise ValueError(
                f"min_available={min_available} must leave a replica to "
                f"restart (fleet has {len(live)} live replica(s))"
            )
        if model is not None:
            self._model = model
        for sup in list(live):
            if sup.status not in ("healthy", "draining"):
                continue  # quarantined replicas are already rebuilding
            healthy_others = sum(
                s is not sup and s.status == "healthy"
                for s in self.replicas
            )
            if healthy_others < min_available:
                raise RuntimeError(
                    f"cannot restart replica {sup.name!r}: only "
                    f"{healthy_others} other healthy replica(s), "
                    f"min_available={min_available}"
                )
            # journal-backed migration instead of stepping out a full
            # drain: in-flight work moves to the pending-queue HEAD and
            # re-places through resume() (greedy byte-identical) while
            # this replica rebuilds — the restart no longer waits for
            # its longest request
            if sup.status == "healthy":
                sup.status = "draining"
            if self.journal is not None:
                self.journal.epoch("restart-begin", replica=sup.name)
                self.journal.flush()
            self._migrate_inflight(sup)
            with span("fleet.restart", replica=sup.name, rolling=True):
                self._absorb_latency(sup)  # folds digests, drops engine
                try:
                    sup.spawn()
                except _DEVICE_FAULTS:
                    raise
                except Exception as e:
                    sup.last_error = f"{type(e).__name__}: {e}"
                    sup.status = "failed"
                    self.metrics.replicas_failed += 1
                    _flight.record(
                        "fleet", "rolling-restart-failed",
                        fleet=self.fleet_id, replica=sup.name,
                        error=sup.last_error,
                    )
                    continue
            self.metrics.restarts += 1
            if self.journal is not None:
                self.journal.epoch("restart-end", replica=sup.name)
                self.journal.flush()
            _flight.record(
                "fleet", "rolling-restart", fleet=self.fleet_id,
                replica=sup.name,
            )
            # migrated work re-places now (possibly straight back onto
            # the rebuilt replica) instead of waiting for the next step
            self._dispatch_pending()
        return self

    # -- scaling -------------------------------------------------------------
    def scale_up(self, reason="manual"):
        """Spawn one replica onto a free placement slice: needs
        ``FleetConfig(placement=)``, which waits for tensor parallelism
        (as the JAX fleet without a plan, this raises)."""
        raise RuntimeError(
            f"fleet {self.fleet_id} has no placement plan: scale_up needs "
            "FleetConfig(placement=) to know which devices a new replica "
            "may use"
        )

    def scale_down(self, replica=None, reason="manual"):
        """Release one replica (named, or the least-loaded healthy
        one): migrate its in-flight work to the pending-queue head,
        fold its telemetry, drop its engine. Returns the released
        supervisor, or None when nothing can shrink (last serving
        replica, no healthy candidate) or the op degraded behind an
        injected ``fleet.scale`` fault. The
        journal brackets the migration in ``shrink-begin``/
        ``shrink-end`` epoch records, so a replay can report a
        mid-shrink crash (delivery stays exactly-once through the
        re-ADMITs' latest-ADMIT-wins keying either way)."""
        if replica is not None:
            sup = (
                self.replica(replica) if isinstance(replica, str)
                else replica
            )
            if sup.status not in ("healthy", "draining"):
                return None
        else:
            cands = [s for s in self.replicas if s.status == "healthy"]
            if not cands:
                return None
            sup = min(cands, key=lambda s: s.load())
        serving_after = sum(
            s is not sup and s.status in ("healthy", "draining")
            for s in self.replicas
        )
        if serving_after < 1:
            return None  # never shrink away the last serving replica
        try:
            faults.fire(
                "fleet.scale", fleet=self.fleet_id, action="down",
                replica=sup.name, reason=reason,
            )
        except Exception as e:
            # the degradation contract of a scaling op: a faulted shrink
            # leaves the fleet as it was
            self.metrics.scale_errors += 1
            _flight.record(
                "fleet", "scale-error", fleet=self.fleet_id,
                action="down", replica=sup.name,
                error=f"{type(e).__name__}: {e}",
            )
            return None
        with span(
            "fleet.scale", action="down", replica=sup.name,
            reason=reason,
        ):
            sup.status = "draining"
            if self.journal is not None:
                self.journal.epoch("shrink-begin", replica=sup.name)
                self.journal.flush()
            migrated = self._migrate_inflight(sup)
            self._absorb_latency(sup)  # folds digests, drops engine
            sup.status = "released"
            self.replicas.remove(sup)
            self._retired.append(sup)
            del self._retired[:-8]
            if self.journal is not None:
                self.journal.epoch("shrink-end", replica=sup.name)
                self.journal.flush()
        self.metrics.scale_downs += 1
        _flight.record(
            "fleet", "scale-down", fleet=self.fleet_id,
            replica=sup.name, reason=reason, migrated=migrated,
        )
        self._dispatch_pending()
        return sup

    def _migrate_inflight(self, sup):
        """Move every in-flight request off ``sup``'s LIVE engine:
        release (KV freed, no finish accounting), re-ADMIT to the
        journal with the emit cursor, and re-queue at the HEAD of the
        pending queue oldest-first — dispatch re-places them through
        the ``resume()`` re-prefill, so greedy continuations are
        byte-identical to an uninterrupted run. The migrated Request
        objects keep their arrival/deadline clocks and QoS fair-queue
        tags: ``_expire_pending`` sees the journaled arrival (TTL
        anchored at admission, not migration) and tenants are charged
        once. The live-engine sibling of ``_on_replica_death``'s
        route sweep; returns the number migrated."""
        eng = sup.engine
        if eng is None:
            return 0
        # finished-but-undelivered / cancelled / hedge routes first:
        # completions are delivered, hedge dispatches are dropped (the
        # primary keeps running elsewhere; resolution is counted at
        # its finish), cancelled losers just release their route
        for d in list(self._routes.values()):
            if d.replica != sup.name:
                continue
            req = d.request
            if req.state is RequestState.FINISHED:
                self._collect(RequestOutput(req))
            elif d.cancelled:
                self._routes.pop(req.request_id, None)
            elif d.kind == "hedge":
                d.finished = True
                self._routes.pop(req.request_id, None)
        moved = []
        slot_reqs = sorted(
            (r for r in eng.slots if r is not None),
            key=lambda r: r.admit_seq,
        )
        for req in slot_reqs + list(eng.waiting):
            d = self._routes.get(req.request_id)
            if (d is None or d.cancelled or d.kind != "primary"
                    or d.fleet_req.done):
                continue
            if eng.release(req.request_id) is None:
                continue
            self._routes.pop(req.request_id, None)
            freq = d.fleet_req
            freq.dispatches.remove(d)
            if self.journal is not None:
                # re-ADMIT with the emit cursor: replay never
                # re-counts tokens this request already produced, and
                # latest-ADMIT-wins makes a replayed migration
                # idempotent
                self.journal.admit(req)
            if self.qos is not None:
                self.qos.on_migrate(req)
            self.metrics.requests_migrated += 1
            _flight.record(
                "fleet", "migrate", fleet=self.fleet_id,
                replica=sup.name, request_id=freq.request_id,
                tokens_kept=len(req.output_token_ids),
            )
            moved.append(freq)
        # HEAD of the queue, oldest first: migrated work has been
        # waiting longest and must not queue behind fresh arrivals
        self._pending.extendleft(reversed(moved))
        if moved and self.journal is not None:
            self.journal.flush()
        return len(moved)

    # -- scheduler internals -------------------------------------------------
    def _sup_or_none(self, name):
        for sup in self.replicas:
            if sup.name == name:
                return sup
        return None

    def _pick_replica(self, exclude=()):
        candidates = [
            s for s in self.replicas
            if s.name not in exclude and s.routable()
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda s: s.load())

    def _step_once(self):
        self._poll_restarts()
        # one error-watermark sweep per step: routable() stays
        # read-only, so health scrapes and repeated _pick_replica
        # calls can't consume the fresh-degraded admission gate
        for sup in self.replicas:
            sup.observe_errors()
        self._expire_pending()
        self._dispatch_pending()
        if self.config.hedge_after_s is not None:
            self._maybe_hedge(time.perf_counter())
        for sup in list(self.replicas):
            if (sup.status not in ("healthy", "draining")
                    or sup.engine is None
                    or not sup.engine.has_unfinished()):
                continue
            try:
                outs = sup.step()
            except _DEVICE_FAULTS:
                # a CUDA error is sticky for the process: every replica's
                # context is gone with it, and a restart would only hide
                # it. The caller stops (the HTTP server's _fail)
                raise
            except Exception as e:
                # a replica death is the event this layer exists to
                # contain: quarantine, failover, restart — never crash
                # the fleet
                self._on_replica_death(sup, e)
                continue
            for out in outs:
                self._collect(out)
        if self.journal is not None:
            # batched EMIT across every primary in flight (the fleet
            # owns the Request objects, which travel with their tokens
            # across replicas) + one group write for the whole fleet
            # step — a near-no-op until the write interval elapses or
            # a completion makes the buffer urgent
            self.journal.step_flush(
                d.request
                for d in self._routes.values()
                if d.kind == "primary" and not d.cancelled
            )
        if self._recovering:
            now = time.perf_counter()
            for req, n0 in list(self._recovering):
                if len(req.output_token_ids) > n0:
                    if self.metrics.last_recovered_token_s is None:
                        # FIRST recovered token since the failover
                        # (reset at death detection) — later requests
                        # must not inflate failover_recovery_s
                        self.metrics.last_recovered_token_s = now
                    self._recovering.remove((req, n0))
                elif req.state is RequestState.FINISHED:
                    # finished WITHOUT a new token (aborted/expired
                    # post-failover): not a recovery sample
                    self._recovering.remove((req, n0))

    def _expire_pending(self):
        """TTL enforcement for requests parked in the fleet pending
        queue: engine-side expiry (``Engine._expire``) only sees
        queued/running requests, so an UNROUTABLE request would
        otherwise outlive its ``ttl_s`` indefinitely. Expired parked
        requests finish with ``"timeout"`` — and any dispatch they
        still hold from a past life (a failover-requeued request's
        live hedge) is cancelled so it stops decoding for a client
        that already timed out."""
        if not self._pending:
            return
        now = time.perf_counter()
        for freq in [
            f for f in self._pending
            if not f.done and f.request.expired(now)
        ]:
            self._pending.remove(freq)
            self.metrics.requests_timeout += 1
            for disp in freq.dispatches:
                if disp.cancelled or disp.finished:
                    continue
                disp.cancelled = True
                sup = self._sup_or_none(disp.replica)
                if sup is not None and sup.engine is not None:
                    sup.engine.abort(disp.request.request_id)
            if freq.hedged:
                self.metrics.hedges_lost += 1
            _flight.record(
                "fleet", "timeout", fleet=self.fleet_id,
                request_id=freq.request_id, where="pending",
                tenant=getattr(freq.request, "tenant", None),
            )
            self._finish_local(freq, "timeout")

    def _poll_restarts(self):
        for sup in self.replicas:
            if sup.status != "quarantined":
                continue
            result = sup.poll()
            if result == "recovered":
                self.metrics.restarts += 1
                _flight.record(
                    "fleet", "replica-recovered", fleet=self.fleet_id,
                    replica=sup.name, restarts=sup.restarts,
                )
            elif result == "failed":
                self.metrics.replicas_failed += 1
                _flight.record(
                    "fleet", "replica-failed", fleet=self.fleet_id,
                    replica=sup.name, error=sup.last_error,
                )

    def _dispatch_pending(self):
        if not self._pending:
            return
        # routable set + loads computed ONCE per sweep (routable()
        # builds a health snapshot; re-deriving it per pending request
        # is O(pending x replicas) of waste), then tracked locally as
        # placements land so least-loaded stays balanced within the
        # sweep
        loads = {s: s.load() for s in self.replicas if s.routable()}
        # per-sweep snapshot of each candidate's cached chain digests
        # (hit-aware routing): chain_digests() walks the whole cache,
        # so it is taken at most once per replica per sweep, not per
        # pending request
        digests = {}
        while self._pending:
            # FIFO without QoS; with QoS attached the sweep dispatches
            # the weighted-fair-share pick (strict priority class,
            # then lowest virtual finish tag) instead of the head
            freq = (
                self._pending[0] if self.qos is None
                else self.qos.select(self._pending)
            )
            if freq is None:
                return
            if freq.done:
                # completed while parked (its hedge won after the
                # primary's replica died): already delivered, must
                # not be dispatched — and decoded — a second time
                self._pending.remove(freq)
                continue
            if not self._dispatch_one(freq, loads, digests):
                return
            self._pending.remove(freq)
            if self.qos is not None and not freq.done:
                # done here means _dispatch_one finished it locally
                # (unplaceable error) — that is not a dispatch, so the
                # global virtual clock must not advance for it
                self.qos.on_dispatch(freq.request)

    def _dispatch_one(self, freq, loads, digests=None):
        """Place one pending request; False leaves it queued (no
        routable replica, admission refused, or an injected
        ``fleet.route`` fault — routing failures degrade to a retry on
        the next step, never to a dropped request)."""
        if not loads:
            return False
        target, affinity = self._route_target(freq, loads, digests)
        try:
            faults.fire(
                "fleet.route", request_id=freq.request_id,
                replica=target.name,
            )
        except Exception as e:
            # an injected routing fault exercises exactly this
            # containment: count it, retry later
            self.metrics.route_errors += 1
            _flight.record(
                "fleet", "route-error", fleet=self.fleet_id,
                request_id=freq.request_id,
                error=f"{type(e).__name__}: {e}",
            )
            return False
        with span(
            "fleet.route", request_id=freq.request_id,
            replica=target.name,
        ):
            try:
                placed = self._place(freq, target)
                if not placed and affinity:
                    # the affinity pick refused admission (warm but
                    # full): retry least-loaded before parking — under
                    # plain least-loaded routing a refusal meant
                    # everyone else was fuller, so halting the sweep
                    # was right; an affinity refusal says nothing
                    # about the other candidates
                    fallback = min(
                        loads,
                        key=lambda s: self._route_weight(s, loads),
                    )
                    if fallback is not target:
                        placed = self._place(freq, fallback)
                        if placed:
                            target, affinity = fallback, False
                if not placed:
                    return False  # shed / queue full: stays pending
            except ValueError as e:
                # unplaceable (admission validation raced an engine
                # rebuild with a stricter config): fail THIS request
                # instead of wedging the pending queue behind it
                self._finish_local(
                    freq, "error", error=f"{type(e).__name__}: {e}",
                )
                return True
        if affinity:
            # counted only for PLACEMENTS won by prefix affinity —
            # refusals and faulted routes must not inflate it
            self.metrics.route_prefix_hits += 1
        d = _Dispatch(freq, freq.request, target.name, "primary")
        freq.dispatches.append(d)
        self._routes[freq.request.request_id] = d
        loads[target] += 1
        return True

    def _place(self, freq, sup):
        """Submit (or resume, after a failover) one request on one
        replica. True = placed; False = admission refused (shed /
        queue full — retry elsewhere or next step). ValueError
        propagates: the request itself is unplaceable."""
        try:
            if freq.request.output_token_ids:
                # failed-over mid-generation: KV must be rebuilt
                # over prompt + output[:-1] (recompute preemption)
                sup.engine.resume(freq.request)
            else:
                sup.engine.submit(freq.request)
        except (EngineOverloadedError, RuntimeError):
            return False
        return True

    def _route_weight(self, sup, loads):
        """Capacity-aware routing key, ascending-better, shared by
        every least-loaded pick (:meth:`_route_target`'s fallback and
        tie-breaks, :meth:`_dispatch_one`'s affinity-refusal retry):
        the load, then KV headroom (free + reclaimable blocks, negated
        so MORE absorbable capacity sorts first). JAX's key divides both
        by the replica's tensor-parallel width; every replica here is
        one device wide."""
        eng = sup.engine
        load = float(loads[sup])
        if eng is None:
            return (load, 0.0)
        return (load, -float(eng.metrics.kv_headroom_blocks))

    def _route_target(self, freq, loads, digests=None):
        """Hit-aware placement: among the routable candidates
        (``loads``), prefer the replica whose prefix cache already
        holds the longest chain match for this prompt — its shared
        blocks are forked instead of recomputed, which is exactly the
        prefill compute a least-loaded bounce would throw away. Ties
        on match length break on :meth:`_route_weight` (load, then KV
        headroom); zero matches anywhere falls
        back to the same weighted least-loaded pick. Affinity is
        load-bounded: a match of n blocks only overrides load while
        the warm replica carries fewer than n extra requests over the
        least-loaded candidate — saving n blocks of prefill is not
        worth queueing behind an arbitrarily deep backlog, so a
        saturated replica with a shallow match cannot capture all
        matching traffic. Resume placements (failover) benefit
        identically: the re-prefill over prompt + output[:-1] starts
        with the same prompt digests. ``digests`` carries the
        per-replica digest-set snapshots across one dispatch sweep;
        the prompt's own digests are cached on the FleetRequest
        (hashed once per lifetime, not per parked-retry sweep).
        Returns ``(supervisor, used_affinity)`` — the caller books the
        prefix-hit counter only once the placement actually lands."""
        best, best_len = None, 0
        if digests is None:
            digests = {}
        min_load = min(loads.values())
        for sup in loads:
            eng = sup.engine
            if eng is None or eng.prefix_cache is None:
                continue
            bs = eng.config.page_size
            want = freq.chain_digests(bs)
            if not want:
                continue
            have = digests.get(sup.name)
            if have is None:
                have = digests[sup.name] = set(
                    eng.prefix_cache.chain_digests()
                )
            n = 0
            for d in want:
                if d not in have:
                    break
                n += 1
            if loads[sup] - min_load >= n:
                continue  # too backlogged for what the match saves
            if n > best_len or (
                n == best_len and n > 0
                and self._route_weight(sup, loads)
                < self._route_weight(best, loads)
            ):
                best, best_len = sup, n
        if best is not None and best_len > 0:
            return best, True
        return (
            min(loads, key=lambda s: self._route_weight(s, loads)),
            False,
        )

    def _maybe_hedge(self, now):
        deadline = self.config.hedge_after_s
        for d in list(self._routes.values()):
            freq = d.fleet_req
            if (freq.done or freq.hedged or d.kind != "primary"
                    or d.cancelled or d.finished
                    or now - d.time <= deadline):
                continue
            target = self._pick_replica(exclude={d.replica})
            if target is None:
                continue
            hreq = Request(
                freq.prompt_token_ids, freq.sampling_params,
                request_id=f"{freq.request_id}::hedge",
            )
            # the hedge serves the SAME client request: anchor its
            # timeline (and TTL deadline) at the primary's arrival so
            # a hedge win reports the latency the client actually saw
            # — including the stall that triggered the hedge — instead
            # of restarting the clock at hedge dispatch (the aborted
            # primary is excluded from the digests, so the winner's
            # sample is the only record of this request's tail)
            hreq.arrival_time = freq.request.arrival_time
            hreq.timeline.arrival = hreq.arrival_time
            hreq.deadline = freq.request.deadline
            with span(
                "fleet.hedge", request_id=freq.request_id,
                replica=target.name,
            ):
                try:
                    target.engine.submit(hreq)
                except (EngineOverloadedError, RuntimeError):
                    continue  # no capacity for a hedge right now
            freq.hedged = True
            hd = _Dispatch(freq, hreq, target.name, "hedge")
            freq.dispatches.append(hd)
            self._routes[hreq.request_id] = hd
            self.metrics.hedges_started += 1
            _flight.record(
                "fleet", "hedge", fleet=self.fleet_id,
                request_id=freq.request_id, replica=target.name,
            )

    def _collect(self, out):
        d = self._routes.pop(out.request_id, None)
        if d is None:
            return  # not fleet-managed
        d.finished = True
        freq = d.fleet_req
        if freq.done or d.cancelled:
            return  # hedge loser / abort echo; resolution already done
        freq.done = True
        # hedge winners carry the engine-side "<id>::hedge" id; clients
        # see their own id regardless of which dispatch won
        out.request_id = freq.request_id
        freq.output = out
        if self.qos is not None:
            self.qos.on_finish(freq.request)
        if self.journal is not None:
            # the journal is keyed by the PRIMARY rid; a hedge winner
            # closes it with the winning reason (the primary's partial
            # tokens are irrelevant once the request is finished)
            self.journal.finish(freq.request, out.finish_reason)
        if freq.hedged:
            if d.kind == "hedge":
                self.metrics.hedges_won += 1
            else:
                self.metrics.hedges_lost += 1
        self.metrics.requests_finished += 1
        for other in freq.dispatches:
            if other is d or other.finished or other.cancelled:
                continue
            other.cancelled = True
            sup = self._sup_or_none(other.replica)
            if sup is not None and sup.engine is not None:
                sup.engine.abort(other.request.request_id)
        self._ready.append(out)

    # -- failover ------------------------------------------------------------
    def _on_replica_death(self, sup, exc):
        """Quarantine a dead replica, re-enqueue its in-flight work on
        healthy replicas (deterministic re-prefill), leave a
        postmortem, and start the background restart."""
        detect = time.perf_counter()
        m = self.metrics
        m.failovers += 1
        m.last_failover_detect_s = detect
        m.last_recovered_token_s = None
        engine = sup.engine
        error = f"{type(exc).__name__}: {exc}"
        _flight.record(
            "fleet", "replica-death", fleet=self.fleet_id,
            replica=sup.name, error=error,
        )
        try:
            probe = engine.health()
        except Exception as he:
            # the engine is torn by definition here; the postmortem
            # records that instead
            probe = {"error": f"health() failed: {he!r}"}
        self._absorb_latency(sup)  # folds digests, drops engine
        sup.quarantine(exc)
        with span("fleet.failover", replica=sup.name, error=error):
            # slot requests resume via appendleft on the survivor, so
            # process them YOUNGEST-first: the chain of appendlefts
            # leaves the oldest work at the head of its new queue.
            # The dead replica's local waiting queue follows in its
            # own (oldest-first) order — those re-place via tail
            # submit, which preserves processing order.
            inflight = sorted(
                (r for r in engine.slots if r is not None),
                key=lambda r: r.admit_seq, reverse=True,
            ) + list(engine.waiting)
            # requests the dying engine had already detached from its
            # scheduler — aborted between steps (``engine._aborted``)
            # or finished during the fatal step itself — still hold
            # live dispatch records; deliver their completions now so
            # no generate()/drain() waiter hangs on a dead route
            for d in list(self._routes.values()):
                if d.replica != sup.name:
                    continue
                req = d.request
                if req.state is RequestState.FINISHED:
                    self._collect(RequestOutput(req))
                elif req not in inflight:
                    inflight.append(req)  # limbo: fail it over too
            for req in inflight:
                d = self._routes.pop(req.request_id, None)
                if d is None or d.fleet_req.done:
                    continue
                freq = d.fleet_req
                if d.cancelled:
                    continue  # an already-aborted hedge loser died with it
                if d.kind == "hedge":
                    # the hedge died, the primary is still running:
                    # drop the hedge rather than failing it over
                    # (resolution is counted at the primary's win)
                    d.finished = True
                    continue
                self._recovering.append(
                    (req, len(req.output_token_ids))
                )
                m.failover_requests += 1
                _flight.record(
                    "fleet", "failover", fleet=self.fleet_id,
                    replica=sup.name, request_id=freq.request_id,
                    tokens_kept=len(req.output_token_ids),
                )
                self._pending.append(freq)
                # drop the dead dispatch record; _dispatch_pending
                # re-places the request (resume path: tokens kept)
                freq.dispatches.remove(d)
        _flight.dump(
            f"replica-death:{sup.name}",
            probes={
                f"serving.replica.{sup.name}": probe,
                f"serving.fleet.{self.fleet_id}": self.snapshot(),
            },
        )
        if sup.start_restart():
            _flight.record(
                "fleet", "restart-started", fleet=self.fleet_id,
                replica=sup.name, attempt=sup.restarts,
            )
        else:
            m.replicas_failed += 1
            _flight.record(
                "fleet", "replica-failed", fleet=self.fleet_id,
                replica=sup.name, error="restart budget exhausted",
            )
        self._dispatch_pending()
