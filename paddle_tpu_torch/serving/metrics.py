"""Engine counters (counterpart of ``paddle_tpu/serving/metrics.py``, cut
to the ones this slice's engine moves). Plain python attributes, bumped
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
        # prefill_tokens counts tokens a prefill launch computed
        # (re-prefills after preemption included)
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self._ttft = []

    def record_ttft(self, seconds):
        self._ttft.append(seconds)

    @property
    def mean_ttft(self):
        return sum(self._ttft) / len(self._ttft) if self._ttft else None
