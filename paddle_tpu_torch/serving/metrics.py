"""Engine counters (counterpart of ``paddle_tpu/serving/metrics.py``, cut
to the ones the port's engine moves). Plain python attributes, bumped
host-side once per event; the per-phase latency digests (queue, ttft,
tpot, e2e) are recorded once per first token or finished request.

Registry view: an EngineMetrics built with an ``engine_id`` publishes
itself into the process-wide ``observability`` registry as a pull-time
collector (``paddle_tpu_serving_*`` series labeled by engine id, the JAX
package's names) plus a latency view
(``paddle_tpu_serving_latency_seconds{phase,quantile}`` and the
cumulative ``..._hist_seconds``). Nothing is written on the hot path: the
registry pulls ``snapshot()`` at scrape time, and a collected engine's
view unregisters itself through the weakref."""
from __future__ import annotations

import time
import weakref

from ..observability.latency import LatencyDigest

__all__ = ["EngineMetrics"]

# snapshot key -> (exposition kind, suffix); monotonics get the
# prometheus _total suffix, instantaneous values export as gauges
_EXPORT_KINDS = {
    "requests_received": ("counter", "_total"),
    "requests_finished": ("counter", "_total"),
    "preemptions": ("counter", "_total"),
    "requests_errored": ("counter", "_total"),
    "requests_timeout": ("counter", "_total"),
    "requests_shed": ("counter", "_total"),
    "prefill_tokens": ("counter", "_total"),
    "decode_tokens": ("counter", "_total"),
    "prefill_steps": ("counter", "_total"),
    "prefill_chunks": ("counter", "_total"),
    "decode_steps": ("counter", "_total"),
    "prefill_compiles": ("counter", "_total"),
    "prefill_ext_compiles": ("counter", "_total"),
    "decode_compiles": ("counter", "_total"),
    "cow_compiles": ("counter", "_total"),
    "verify_compiles": ("counter", "_total"),
    "verify_steps": ("counter", "_total"),
    "spec_proposed": ("counter", "_total"),
    "spec_accepted": ("counter", "_total"),
    "spec_accept_rate": ("gauge", ""),
    "prefix_lookups": ("counter", "_total"),
    "prefix_hits": ("counter", "_total"),
    "prefix_hit_tokens": ("counter", "_total"),
    "prefix_evictions": ("counter", "_total"),
    "prefix_restores": ("counter", "_total"),
    "cow_copies": ("counter", "_total"),
    "queue_depth": ("gauge", ""),
    "num_running": ("gauge", ""),
    "cache_utilization": ("gauge", ""),
    "kv_active_utilization": ("gauge", ""),
    "kv_reclaimable_blocks": ("gauge", ""),
    "kv_headroom_blocks": ("gauge", ""),
    "prefix_cache_blocks": ("gauge", ""),
    "pool_high_water": ("gauge", ""),
    "mean_ttft_s": ("gauge", ""),
    "tokens_per_s": ("gauge", ""),
}


def _register_view(metrics, engine_id):
    """Collector views over one EngineMetrics: called only at scrape
    time, holding the metrics object by weakref (a dead engine's views
    return None and the registry drops them)."""
    from ..observability import MetricFamily, get_registry
    from ..observability.metrics import register_latency_view

    ref = weakref.ref(metrics)
    label = {"engine": engine_id}

    def latency_view():
        m = ref()
        return None if m is None else m.latency

    register_latency_view(
        f"serving.latency.{engine_id}", latency_view,
        "paddle_tpu_serving_latency", labels=label,
    )

    def collect():
        m = ref()
        if m is None:
            return None
        fams = []
        for key, value in m.snapshot().items():
            kind_suffix = _EXPORT_KINDS.get(key)
            if kind_suffix is None or value is None:
                continue  # non-numeric (last_error) / unset latencies
            kind, suffix = kind_suffix
            fams.append(MetricFamily(
                f"paddle_tpu_serving_{key}{suffix}", kind,
            ).add(value, label))
        if m.program_bytes:
            # predicted per-device peak per serving program (the
            # analyzer's memory-budget source), one sample per program
            fam = MetricFamily(
                "paddle_tpu_serving_program_bytes", "gauge",
            )
            for prog, nbytes in sorted(m.program_bytes.items()):
                fam.add(nbytes, {**label, "program": prog})
            fams.append(fam)
        hist = m.spec_accept_hist()
        if hist:
            # per-step accepted-draft-length histogram (the observed
            # lengths 0..K are the bucket bounds)
            fam = MetricFamily(
                "paddle_tpu_serving_spec_accept_length", "histogram",
            )
            acc, total = 0, 0.0
            for le in sorted(hist):
                acc += hist[le]
                total += le * hist[le]
                fam.add(acc, {**label, "le": str(le)}, "_bucket")
            fam.add(acc, {**label, "le": "+Inf"}, "_bucket")
            fam.add(total, label, "_sum")
            fam.add(acc, label, "_count")
            fams.append(fam)
        tracker = m.slo
        if tracker is not None:
            # windowed error-budget burn: 1.0 = spending the budget as
            # allotted; the burning gauge also flips health()["flags"]
            fam = MetricFamily("paddle_tpu_serving_slo_burn_rate", "gauge")
            for sig, v in sorted(tracker.burn_rates().items()):
                if v is not None:
                    fam.add(v, {**label, "signal": sig})
            if fam.samples:
                fams.append(fam)
            fams.append(MetricFamily(
                "paddle_tpu_serving_slo_burning", "gauge",
            ).add(1.0 if tracker.burning() else 0.0, label))
        return fams

    get_registry().register_collector(f"serving.engine.{engine_id}",
                                      collect)


class EngineMetrics:
    def __init__(self, engine_id=None):
        self.start_time = time.perf_counter()
        self.requests_received = 0
        self.requests_finished = 0
        # poison requests the engine finished with "error" (and the last
        # one's "request <id>: <ExcType>: <msg>"), keeping the batch
        self.requests_errored = 0
        self.last_error = None
        self.requests_timeout = 0
        self.requests_shed = 0
        self.preemptions = 0
        # programs built: one per capture on the card (one per program
        # on the CPU, where the same function runs eagerly) — the JAX
        # engine's compile probes
        self.decode_compiles = 0
        self.prefill_compiles = 0
        self.prefill_ext_compiles = 0   # continuation programs (buckets)
        self.cow_compiles = 0
        self.verify_compiles = 0        # the speculative verify program
        # prefill_tokens counts tokens a prefill launch COMPUTED
        # (re-prefills after preemption included): prefix-cache hits
        # subtract from it, the saving prefix_hit_tokens measures
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.prefill_steps = 0
        self.prefill_chunks = 0   # chunk launches through prefill_ext
        self.decode_steps = 0
        # speculative decoding: verify launches, draft tokens proposed by
        # the prompt-lookup drafter, and drafts the target argmax accepted
        # (the spec_accept_rate numerator); the per-slot accepted-length
        # distribution of every verify launch that had a draft
        self.verify_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._spec_accept_counts = {}
        # prefix cache (serving/prefix_cache.py): lookups and hits at
        # admission, hit_tokens = prompt tokens served from shared blocks
        # instead of recomputed, cow_copies = partial-block copy-on-write
        # divergences, evictions = cached blocks released
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0
        # chain blocks re-materialized from the host spill tier
        # (serving/spill.py) by a lookup that ran into a demoted chain
        self.prefix_restores = 0
        self.cow_copies = 0
        # predicted per-device peak bytes of each summarized serving
        # program ({"decode": ..., "prefill[16]": ...}), filled by the
        # analyzer's level 3 (Engine.check_compiled_programs) and
        # exported as paddle_tpu_serving_program_bytes{program=}
        self.program_bytes: dict = {}
        # gauges, refreshed by the engine every step
        self.queue_depth = 0
        self.num_running = 0
        self.cache_utilization = 0.0
        self.kv_active_utilization = 0.0
        self.kv_reclaimable_blocks = 0
        self.kv_headroom_blocks = 0
        self.prefix_cache_blocks = 0
        self.pool_high_water = 0
        # one mergeable quantile sketch per phase; mean_ttft derives from
        # the ttft digest, so the mean_ttft_s gauge and the exported p50
        # share one source
        self.latency = {
            phase: LatencyDigest()
            for phase in ("queue", "ttft", "tpot", "e2e")
        }
        # SLO burn tracker, attached by the engine when
        # EngineConfig(slo=) is set; exported by the collector view
        self.slo = None
        # registry view registered LAST: a scrape racing construction
        # must find every attribute snapshot() reads already in place
        if engine_id is not None:
            _register_view(self, engine_id)

    def record_ttft(self, seconds):
        self.latency["ttft"].record(seconds)

    def record_spec_accept(self, n):
        """One verify launch accepted ``n`` draft tokens for one slot."""
        n = int(n)
        self._spec_accept_counts[n] = self._spec_accept_counts.get(n, 0) + 1

    def spec_accept_hist(self):
        """{accepted_length: observations} (a copy)."""
        return dict(self._spec_accept_counts)

    @property
    def spec_accept_rate(self):
        """Accepted over proposed draft tokens; None before any draft."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else None)

    @property
    def mean_ttft(self):
        """The ttft digest's exact sum / count (not a bucket value)."""
        return self.latency["ttft"].mean

    def tokens_per_second(self):
        dt = time.perf_counter() - self.start_time
        return (self.prefill_tokens + self.decode_tokens) / dt if dt else 0.0

    def snapshot(self):
        """One dict, stable keys: what the registry view exports."""
        return {
            "requests_received": self.requests_received,
            "requests_finished": self.requests_finished,
            "preemptions": self.preemptions,
            "requests_errored": self.requests_errored,
            "requests_timeout": self.requests_timeout,
            "requests_shed": self.requests_shed,
            "queue_depth": self.queue_depth,
            "num_running": self.num_running,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_evictions": self.prefix_evictions,
            "prefix_restores": self.prefix_restores,
            "cow_copies": self.cow_copies,
            "prefill_steps": self.prefill_steps,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "verify_steps": self.verify_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": self.spec_accept_rate,
            "prefill_compiles": self.prefill_compiles,
            "prefill_ext_compiles": self.prefill_ext_compiles,
            "decode_compiles": self.decode_compiles,
            "cow_compiles": self.cow_compiles,
            "verify_compiles": self.verify_compiles,
            "cache_utilization": self.cache_utilization,
            "kv_active_utilization": self.kv_active_utilization,
            "kv_reclaimable_blocks": self.kv_reclaimable_blocks,
            "kv_headroom_blocks": self.kv_headroom_blocks,
            "prefix_cache_blocks": self.prefix_cache_blocks,
            "pool_high_water": self.pool_high_water,
            "mean_ttft_s": self.mean_ttft,
            "tokens_per_s": self.tokens_per_second(),
            "last_error": self.last_error,
        }
