"""Engine counters (counterpart of ``paddle_tpu/serving/metrics.py``, cut
to the ones the port's engine moves). Plain python attributes, bumped
host-side once per event. The registry view and the latency digests of
the JAX version wait for the observability slice."""
from __future__ import annotations

__all__ = ["EngineMetrics"]


class EngineMetrics:
    def __init__(self):
        self.requests_received = 0
        self.requests_finished = 0
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
        # prefill_tokens counts tokens a prefill launch COMPUTED
        # (re-prefills after preemption included): prefix-cache hits
        # subtract from it, the saving prefix_hit_tokens measures
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.prefill_steps = 0
        self.prefill_chunks = 0   # chunk launches through prefill_ext
        self.decode_steps = 0
        # prefix cache (serving/prefix_cache.py): lookups and hits at
        # admission, hit_tokens = prompt tokens served from shared blocks
        # instead of recomputed, cow_copies = partial-block copy-on-write
        # divergences, evictions = cached blocks released
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0
        self.cow_copies = 0
        # gauge: entries the prefix cache holds, refreshed every step
        self.prefix_cache_blocks = 0
        self._ttft = []

    def record_ttft(self, seconds):
        self._ttft.append(seconds)

    @property
    def mean_ttft(self):
        return sum(self._ttft) / len(self._ttft) if self._ttft else None
