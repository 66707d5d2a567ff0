"""Multi-tenant QoS under the HTTP front door (counterpart of
``paddle_tpu/serving/qos.py``; the same policies, counters and series).

One noisy tenant must not eat another's p99:

  * **Identity** — API-key -> tenant mapping (``Authorization: Bearer
    <key>`` on the wire) or a trusted ``X-Tenant`` header; requests with
    no identity fall to ``default_tenant`` (or are rejected when it is
    None).
  * **Scheduling** — strict priority classes, weighted fair share within
    a class: start-time-fair-queuing virtual time, each admission
    advancing its tenant's virtual finish tag by ``cost / weight`` (cost
    = ``max_new_tokens``); :meth:`QoS.select` picks the lowest
    ``(priority, tag)`` from a pending queue. A ``serving.Fleet`` with
    this QoS attached (:meth:`QoS.attach`, as the server does) dispatches
    its pending queue through it; a single engine's admission stays first
    come, first served, and the tags are only stamped.
  * **Shedding** — per-tenant quotas (``max_inflight``) and token-rate
    limits (a token bucket over estimated decode tokens) reject with a
    :class:`QoSRejection` the server maps to HTTP 429 + ``Retry-After``;
    a tenant whose own SLO burn is *sustained* is shed first once the
    waiting (or the fleet's pending) queue crosses ``shed_burning_at x
    capacity``.

Telemetry: per-tenant latency digests and SLO burn reuse
``LatencyDigest`` / ``SLOTracker``, exported at pull time as
``paddle_tpu_serving_latency*{tenant=}``,
``paddle_tpu_serving_slo_*{tenant=}`` and
``paddle_tpu_serving_tenant_*{tenant=}`` series through weakref
collector views. Tenant ids also ride the journal ADMIT record
(``"tn"``), so a crash replay restores the per-tenant accounting.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref

from ..observability.latency import LatencyDigest, SLOConfig, SLOTracker

__all__ = [
    "TenantPolicy", "QoSConfig", "QoS", "QoSRejection",
    "UnknownTenantError",
]

# monotonic ids for collector-view names (labels/views must never
# alias across QoS lifetimes — the engine/journal counter rationale)
_qos_counter = itertools.count(1)

_DEFAULT_TENANT = "default"


class QoSRejection(Exception):
    """Admission refused by QoS policy; the server maps this to HTTP
    429 with ``Retry-After: ceil(retry_after)``."""

    def __init__(self, tenant, reason, retry_after=1.0, message=None):
        self.tenant = tenant
        self.reason = reason          # "quota" | "rate" | "slo-burn"
        self.retry_after = max(0.0, float(retry_after))
        super().__init__(
            message or f"tenant {tenant!r} shed ({reason}); retry "
            f"after {self.retry_after:.1f}s"
        )


class UnknownTenantError(Exception):
    """No tenant identity could be established (bad API key, or no
    identity with ``default_tenant=None``); the server maps this to
    HTTP 401."""


class TenantPolicy:
    """Per-tenant knobs. ``weight`` is the fair-share proportion
    within a priority class; ``priority`` classes are strict (0 beats
    1 whenever class 0 has pending work); ``max_inflight`` bounds
    concurrently admitted requests; ``tokens_per_s`` caps the
    estimated decode-token admission rate (burst defaults to one
    second of rate, floor 1)."""

    def __init__(self, weight=1.0, priority=1, max_inflight=None,
                 tokens_per_s=None, burst_tokens=None, slo=None):
        if not weight > 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1 or None, got {max_inflight}"
            )
        if tokens_per_s is not None and not tokens_per_s > 0:
            raise ValueError(
                f"tokens_per_s must be > 0 or None, got {tokens_per_s}"
            )
        self.weight = float(weight)
        self.priority = int(priority)
        self.max_inflight = (
            None if max_inflight is None else int(max_inflight)
        )
        self.tokens_per_s = (
            None if tokens_per_s is None else float(tokens_per_s)
        )
        self.burst_tokens = (
            max(1.0, float(burst_tokens)) if burst_tokens is not None
            else (
                max(1.0, self.tokens_per_s)
                if self.tokens_per_s is not None else None
            )
        )
        if slo is not None and not isinstance(slo, SLOConfig):
            raise ValueError(
                f"slo must be an SLOConfig or None, got "
                f"{type(slo).__name__}"
            )
        self.slo = slo


class QoSConfig:
    """QoS layer configuration.

    ``tenants`` maps tenant name -> :class:`TenantPolicy` (unknown
    tenant names get a fresh default policy on first sight);
    ``api_keys`` maps bearer key -> tenant name; ``default_tenant``
    names the tenant for unauthenticated requests (None rejects
    them); ``slo`` is the default per-tenant SLO applied where a
    policy doesn't carry its own; ``shed_burning_at`` is the pending
    backlog fraction past which sustained-burning tenants are shed
    first."""

    def __init__(self, tenants=None, api_keys=None,
                 default_tenant=_DEFAULT_TENANT, slo=None,
                 shed_burning_at=0.5):
        tenants = dict(tenants or {})
        for name, pol in tenants.items():
            if not isinstance(pol, TenantPolicy):
                raise ValueError(
                    f"tenants[{name!r}] must be a TenantPolicy, got "
                    f"{type(pol).__name__}"
                )
        self.tenants = tenants
        self.api_keys = dict(api_keys or {})
        self.default_tenant = default_tenant
        if slo is not None and not isinstance(slo, SLOConfig):
            raise ValueError(
                f"slo must be an SLOConfig or None, got "
                f"{type(slo).__name__}"
            )
        self.slo = slo
        if not 0.0 <= shed_burning_at <= 1.0:
            raise ValueError(
                f"shed_burning_at must be in [0, 1], got "
                f"{shed_burning_at}"
            )
        self.shed_burning_at = float(shed_burning_at)


class _TokenBucket:
    """Classic token bucket over *estimated* decode tokens (charged at
    admission — the cheap place to push back; an admitted request's
    true cost is bounded by the estimate)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = time.monotonic()

    def try_take(self, n, now=None):
        """Take ``n`` tokens; returns 0.0 on success, else the seconds
        until ``n`` tokens will be available (the Retry-After)."""
        now = time.monotonic() if now is None else now
        self.tokens = min(
            self.burst, self.tokens + (now - self.stamp) * self.rate
        )
        self.stamp = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class _TenantState:
    """Live accounting for one tenant (policy + fair-share virtual
    time + inflight set + digests/SLO + counters)."""

    def __init__(self, name, policy, default_slo):
        self.name = name
        self.policy = policy
        self.vtime = 0.0              # fair-queuing virtual finish tag
        self.inflight: set = set()    # admitted-not-finished rids
        self.bucket = (
            _TokenBucket(policy.tokens_per_s, policy.burst_tokens)
            if policy.tokens_per_s is not None else None
        )
        self.latency = {
            p: LatencyDigest() for p in ("queue", "ttft", "tpot", "e2e")
        }
        slo_cfg = policy.slo or default_slo
        self.slo = SLOTracker(slo_cfg) if slo_cfg is not None else None
        # counters (plain attributes; exported by the collector view)
        self.received = 0
        self.finished = 0
        self.aborted = 0
        self.shed_quota = 0
        self.shed_rate = 0
        self.shed_burn = 0
        self.shed_queue = 0
        self.output_tokens = 0
        self.restored = 0
        self.migrated = 0


class QoS:
    """The runtime QoS object: identity resolution, fair-share
    selection over a pending queue, quota/rate/burn shedding, and
    per-tenant telemetry. Thread-safe (the HTTP server calls it from
    handler threads and from its driver thread)."""

    def __init__(self, config=None):
        self.config = config or QoSConfig()
        self.qos_id = f"{next(_qos_counter)}"
        self._lock = threading.Lock()
        self._states: dict = {}       # tenant name -> _TenantState
        self._vclock = 0.0            # global virtual time
        _register_view(self, self.qos_id)
        # eagerly materialize configured tenants so their series exist
        # (and their buckets start full) before the first request
        for name in self.config.tenants:
            self._state(name)

    # -- identity ------------------------------------------------------------
    def resolve(self, headers):
        """Tenant name from request headers (case-insensitive keys):
        ``Authorization: Bearer <key>`` through the API-key map wins,
        then a trusted ``X-Tenant`` header, then ``default_tenant``.
        A *presented-but-unknown* key and an identity-free request
        under ``default_tenant=None`` raise
        :class:`UnknownTenantError` (HTTP 401)."""
        lower = {str(k).lower(): v for k, v in dict(headers).items()}
        auth = lower.get("authorization")
        if auth:
            key = auth.strip()
            if key.lower().startswith("bearer "):
                key = key[7:].strip()
            tenant = self.config.api_keys.get(key)
            if tenant is None:
                raise UnknownTenantError("unknown API key")
            return tenant
        tenant = lower.get("x-tenant")
        if tenant:
            return str(tenant)
        if self.config.default_tenant is None:
            raise UnknownTenantError(
                "no tenant identity and anonymous access is disabled"
            )
        return self.config.default_tenant

    def _state(self, tenant):
        name = tenant if tenant is not None else (
            self.config.default_tenant or _DEFAULT_TENANT
        )
        st = self._states.get(name)
        if st is None:
            policy = self.config.tenants.get(name) or TenantPolicy()
            st = _TenantState(name, policy, self.config.slo)
            self._states[name] = st
            _register_tenant_latency_view(self, st)
        return st

    # -- admission -----------------------------------------------------------
    def try_admit(self, tenant, cost_tokens, backlog=0, capacity=None):
        """Policy gate BEFORE the backend sees the request. Raises
        :class:`QoSRejection` (-> 429 + Retry-After) on a quota,
        rate, or burn-shed violation; returns the tenant's state on
        success (nothing is charged until :meth:`on_admit`, except the
        rate bucket, which charges here — the rejected request must
        not consume budget twice on retry)."""
        with self._lock:
            st = self._state(tenant)
            pol = st.policy
            if (pol.max_inflight is not None
                    and len(st.inflight) >= pol.max_inflight):
                st.shed_quota += 1
                raise QoSRejection(
                    st.name, "quota", retry_after=1.0,
                    message=(
                        f"tenant {st.name!r} at max_inflight="
                        f"{pol.max_inflight}"
                    ),
                )
            # sustained-burn shed: once the shared queue is past the
            # threshold, the tenant already burning ITS error budget
            # is pushed back first (everyone else keeps admitting)
            if (capacity is not None and st.slo is not None
                    and backlog >= self.config.shed_burning_at * capacity
                    and st.slo.burning()):
                st.shed_burn += 1
                raise QoSRejection(
                    st.name, "slo-burn", retry_after=1.0,
                    message=(
                        f"tenant {st.name!r} shed: sustained SLO burn "
                        f"with {backlog} request(s) queued"
                    ),
                )
            if st.bucket is not None:
                wait = st.bucket.try_take(max(1.0, float(cost_tokens)))
                if wait > 0.0:
                    st.shed_rate += 1
                    raise QoSRejection(
                        st.name, "rate", retry_after=wait,
                        message=(
                            f"tenant {st.name!r} over "
                            f"{pol.tokens_per_s:g} tokens/s"
                        ),
                    )
            return st

    def on_admit(self, req, restored=False):
        """Account an accepted request (tenant read off the Request —
        the journal-restored path and the live path share it), and
        stamp its fair-queuing virtual tags: start = max(tenant's last
        finish, the global virtual clock), finish = start +
        cost/weight. Stamped ONCE at admission — a parked request's
        tag must age relative to later arrivals, which is what lets a
        backlogged low-weight tenant interleave instead of starve."""
        with self._lock:
            st = self._state(getattr(req, "tenant", None))
            self._stamp(st, req)
            st.inflight.add(req.request_id)
            st.received += 1
            if restored:
                st.restored += 1

    def _stamp(self, st, req):
        cost = float(req.sampling_params.max_new_tokens)
        start = max(st.vtime, self._vclock)
        st.vtime = start + cost / st.policy.weight
        req._qos_vstart = start
        req._qos_vtag = st.vtime

    def on_migrate(self, req):
        """A scale-down or rolling restart moved this in-flight request
        off its replica: count it, nothing else. No re-stamp (the
        admission-time fair-queue tags survive: a migrated request keeps
        its place in the tenant's virtual timeline, it did not arrive
        again), no ``received`` increment, and the rid stays in the
        tenant's ``inflight`` set (it still is)."""
        with self._lock:
            self._state(getattr(req, "tenant", None)).migrated += 1

    def count_queue_shed(self, tenant):
        """The backend's bounded queue refused (fleet ``max_pending``,
        engine ``max_waiting`` or KV shedding): counted per tenant so a
        saturated queue's pushback is attributable."""
        with self._lock:
            self._state(tenant).shed_queue += 1

    # -- weighted fair share over the pending queue --------------------------
    def select(self, pending):
        """Pick the next entry of ``pending`` (entries carrying
        ``.done`` and ``.request``, as the JAX fleet's pending queue of
        FleetRequests) to dispatch: delivered-but-parked entries first
        (the caller purges them), else the lowest ``(priority class,
        admission-stamped virtual finish tag)``. Ties keep FIFO order.
        Returns None for an empty queue."""
        with self._lock:
            best = None
            best_key = None
            for freq in pending:
                if freq.done:
                    return freq
                req = freq.request
                st = self._state(getattr(req, "tenant", None))
                tag = getattr(req, "_qos_vtag", None)
                if tag is None:
                    # admitted before this QoS was attached: stamp now
                    self._stamp(st, req)
                    tag = req._qos_vtag
                key = (st.policy.priority, tag)
                if best_key is None or key < best_key:
                    best, best_key = freq, key
            return best

    def on_dispatch(self, req):
        """Advance the global virtual clock to the dispatched
        request's start tag, so tenants arriving after a long idle
        period stamp from the present instead of banking credit."""
        with self._lock:
            start = getattr(req, "_qos_vstart", None)
            if start is not None:
                self._vclock = max(self._vclock, start)

    # -- completion ----------------------------------------------------------
    def on_finish(self, req):
        """Close the accounting for one finished request: inflight
        released, latency digests + SLO window fed (aborts excluded —
        the ``record_finish`` convention), output tokens counted.
        Idempotent per rid."""
        with self._lock:
            st = self._state(getattr(req, "tenant", None))
            if req.request_id not in st.inflight:
                return
            st.inflight.discard(req.request_id)
            st.finished += 1
            n_out = len(req.output_token_ids)
            st.output_tokens += n_out
            if req.finish_reason == "aborted":
                st.aborted += 1
                return
            tl = req.timeline
            tpot = tl.tpot_s(n_out)
            for phase, value in (
                ("queue", tl.queue_wait_s), ("ttft", tl.ttft_s),
                ("tpot", tpot), ("e2e", tl.e2e_s),
            ):
                if value is not None:
                    st.latency[phase].record(value)
            if st.slo is not None:
                st.slo.record(ttft_s=tl.ttft_s, tpot_s=tpot)

    def attach(self, fleet):
        """Install this QoS on a Fleet: the fleet's dispatch sweep
        consults :meth:`select`/:meth:`on_dispatch`, and any requests the
        fleet already holds (its journal replay ran in its constructor)
        are folded into the inflight accounting."""
        if fleet.qos is self:
            return  # already attached; don't re-account pending
        fleet.qos = self
        for freq in list(fleet._pending):
            if not freq.done:
                self.on_admit(freq.request, restored=True)

    # -- introspection -------------------------------------------------------
    def tenants(self):
        with self._lock:
            return sorted(self._states)

    def inflight(self, tenant):
        with self._lock:
            return len(self._state(tenant).inflight)

    def snapshot(self):
        """{tenant: counters} — tests and the CLI read this."""
        with self._lock:
            return {
                name: {
                    "inflight": len(st.inflight),
                    "received": st.received,
                    "finished": st.finished,
                    "aborted": st.aborted,
                    "restored": st.restored,
                    "migrated": st.migrated,
                    "shed_quota": st.shed_quota,
                    "shed_rate": st.shed_rate,
                    "shed_burn": st.shed_burn,
                    "shed_queue": st.shed_queue,
                    "output_tokens": st.output_tokens,
                }
                for name, st in self._states.items()
            }


# -- telemetry views ---------------------------------------------------------
_TENANT_COUNTERS = {
    "received": "paddle_tpu_serving_tenant_requests_total",
    "finished": "paddle_tpu_serving_tenant_finished_total",
    "aborted": "paddle_tpu_serving_tenant_aborted_total",
    "restored": "paddle_tpu_serving_tenant_restored_total",
    "migrated": "paddle_tpu_serving_tenant_migrated_total",
    "shed_quota": "paddle_tpu_serving_tenant_shed_quota_total",
    "shed_rate": "paddle_tpu_serving_tenant_shed_rate_total",
    "shed_burn": "paddle_tpu_serving_tenant_shed_burn_total",
    "shed_queue": "paddle_tpu_serving_tenant_shed_queue_total",
    "output_tokens": "paddle_tpu_serving_tenant_output_tokens_total",
}


def _register_view(qos, qos_id):
    """Pull-time collector over every tenant of one QoS (weakref: a
    collected QoS unregisters itself). Best-effort: telemetry must
    never fail admission."""
    try:
        from ..observability import MetricFamily, get_registry
    except Exception:
        # observability is optional here
        return
    ref = weakref.ref(qos)

    def collect():
        q = ref()
        if q is None:
            return None
        fams = []
        with q._lock:
            states = list(q._states.values())
        counters = {
            series: MetricFamily(series, "counter")
            for series in _TENANT_COUNTERS.values()
        }
        inflight = MetricFamily(
            "paddle_tpu_serving_tenant_inflight", "gauge"
        )
        burn = MetricFamily(
            "paddle_tpu_serving_slo_burn_rate", "gauge"
        )
        burning = MetricFamily(
            "paddle_tpu_serving_slo_burning", "gauge"
        )
        for st in states:
            label = {"tenant": st.name}
            for attr, series in _TENANT_COUNTERS.items():
                counters[series].add(getattr(st, attr), label)
            inflight.add(len(st.inflight), label)
            if st.slo is not None:
                for sig, v in sorted(st.slo.burn_rates().items()):
                    if v is not None:
                        burn.add(v, {**label, "signal": sig})
                burning.add(
                    1.0 if st.slo.burning() else 0.0, label
                )
        fams.extend(counters.values())
        fams.append(inflight)
        if burn.samples:
            fams.append(burn)
        if burning.samples:
            fams.append(burning)
        return fams

    try:
        get_registry().register_collector(f"serving.qos.{qos_id}",
                                          collect)
    except Exception:
        # telemetry is best-effort
        pass


def _register_tenant_latency_view(qos, st):
    """Per-tenant latency digest view: the same
    ``paddle_tpu_serving_latency*`` families the engine exports, with
    a ``tenant`` label instead of an ``engine`` one (the registry
    merges same-name families across collectors)."""
    try:
        from ..observability.metrics import register_latency_view
    except Exception:
        # observability is optional here
        return
    ref = weakref.ref(st)

    def latency_view():
        s = ref()
        return None if s is None else s.latency

    try:
        register_latency_view(
            f"serving.qos.{qos.qos_id}.{st.name}", latency_view,
            "paddle_tpu_serving_latency", labels={"tenant": st.name},
        )
    except Exception:
        # telemetry is best-effort
        pass
