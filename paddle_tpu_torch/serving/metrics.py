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
        self.cow_copies = 0
        # gauge: entries the prefix cache holds, refreshed every step
        self.prefix_cache_blocks = 0
        self._ttft = []

    def record_ttft(self, seconds):
        self._ttft.append(seconds)

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
        return sum(self._ttft) / len(self._ttft) if self._ttft else None
