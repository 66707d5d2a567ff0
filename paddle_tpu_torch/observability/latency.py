"""Streaming latency quantiles + SLO error-budget burn tracking
(counterpart of ``paddle_tpu/observability/latency.py``, the same bucket
scheme, so a digest's quantiles equal the JAX package's on the same
samples).

  * :class:`LatencyDigest` — a mergeable log-bucketed histogram sketch:
    ``record()`` is O(1), quantiles are computed at pull time, and
    ``merge()`` adds bucket counts (a merge of per-engine digests equals
    one pooled digest). Relative error is bounded by the bucket growth
    factor (default 9 % a bucket, at most ~4.5 % off a quantile).
  * :class:`SLOConfig` / :class:`SLOTracker` — windowed error-budget
    burn: "p99 TTFT <= 300 ms" allows 1 % of requests over the target;
    the burn rate is ``violating_fraction / budget`` over a sliding
    window. Sustained burn (>= ``burn_threshold`` with >=
    ``min_samples`` in the window) flips ``Engine.health()["flags"]``,
    and so ``/healthz``, to degraded.

Digests live on plain metrics structs; the registry pulls them at
scrape time through ``metrics.register_latency_view``.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "LatencyDigest", "SLOConfig", "SLOTracker",
    "summary_family", "histogram_family", "burn_from_counts",
    "sustained_burn",
]

# default bucket growth: each bucket's bound is 9% above the previous,
# giving ~175 buckets across 1us..1h and a worst-case quantile error
# of half a bucket (~4.5%) — far inside scheduler jitter
DEFAULT_GROWTH = 1.09
DEFAULT_MIN = 1e-6          # floor bucket: everything <= 1us


class LatencyDigest:
    """Mergeable log-bucketed quantile sketch over positive seconds."""

    __slots__ = ("growth", "min_value", "_log_growth", "_counts",
                 "_count", "_sum", "_max", "_lock")

    def __init__(self, growth=DEFAULT_GROWTH, min_value=DEFAULT_MIN):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_growth = math.log(self.growth)
        self._counts: dict = {}    # bucket index -> observations
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    # -- recording (hot-ish path: once per finished request) ---------------
    def record(self, value):
        """O(1): one log(), one dict bump. Non-positive values land in
        the floor bucket (a 0s queue wait is a real observation)."""
        v = float(value)
        if v <= self.min_value:
            idx = 0
        else:
            idx = int(math.ceil(
                math.log(v / self.min_value) / self._log_growth
            ))
        with self._lock:
            self._counts[idx] = self._counts.get(idx, 0) + 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    # -- pull-time views ---------------------------------------------------
    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def mean(self):
        return self._sum / self._count if self._count else None

    def snapshot(self):
        """``(counts_dict, count, sum, max)`` under the lock — what
        merge/quantile/export read so a concurrent record never tears
        a view."""
        with self._lock:
            return dict(self._counts), self._count, self._sum, self._max

    def _value_of(self, idx):
        """Representative value of bucket ``idx``: the geometric
        midpoint of its bounds (floor bucket reports min_value)."""
        if idx <= 0:
            return self.min_value
        return self.min_value * self.growth ** (idx - 0.5)

    def quantile(self, q):
        """q-th quantile (0..1) at pull time, or None when empty. The
        reported value is the representative of the bucket holding the
        q-th observation — within half a bucket of the true value."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        counts, count, _, mx = self.snapshot()
        if not count:
            return None
        target = q * count
        acc = 0
        for idx in sorted(counts):
            acc += counts[idx]
            if acc >= target:
                # don't report past the true maximum (the top bucket's
                # midpoint can exceed it)
                return min(self._value_of(idx), mx) if mx else (
                    self._value_of(idx)
                )
        return mx

    def merge(self, other):
        """Fold ``other`` into self (bucket counts add): merging
        per-replica digests equals one pooled digest exactly. Both
        digests must share the bucket scheme."""
        if (other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError(
                "cannot merge digests with different bucket schemes "
                f"(growth {other.growth} vs {self.growth}, min "
                f"{other.min_value} vs {self.min_value})"
            )
        counts, count, total, mx = other.snapshot()
        with self._lock:
            for idx, c in counts.items():
                self._counts[idx] = self._counts.get(idx, 0) + c
            self._count += count
            self._sum += total
            if mx > self._max:
                self._max = mx
        return self

    def copy(self):
        out = LatencyDigest(self.growth, self.min_value)
        return out.merge(self)

    def __repr__(self):
        return (
            f"LatencyDigest(n={self._count}, "
            f"p50={self.quantile(0.5)}, p99={self.quantile(0.99)})"
        )


DEFAULT_QUANTILES = (0.5, 0.9, 0.99)

# cumulative-histogram bounds for the Prometheus-native export
# (seconds; mirrors metrics.DEFAULT_BUCKETS with a finer sub-10ms tail
# for TPOT-scale values)
DEFAULT_HIST_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


def summary_family(name, digests, labels=None,
                   quantiles=DEFAULT_QUANTILES):
    """One Prometheus *summary* family over ``digests`` (a dict
    ``phase -> LatencyDigest``): quantile-labeled series plus
    ``_sum``/``_count`` per phase. Empty digests export nothing (an
    absent series is a cleaner "no data yet" than a fake 0)."""
    from .metrics import MetricFamily

    fam = MetricFamily(name, "summary")
    base = dict(labels or {})
    for phase in sorted(digests):
        d = digests[phase]
        counts, count, total, mx = d.snapshot()
        if not count:
            continue
        pl = {**base, "phase": phase}
        for q in quantiles:
            fam.add(d.quantile(q), {**pl, "quantile": f"{q:g}"})
        fam.add(total, pl, "_sum")
        fam.add(count, pl, "_count")
    return fam


def histogram_family(name, digests, labels=None,
                     bounds=DEFAULT_HIST_BOUNDS):
    """Prometheus-native cumulative histogram over the same digests
    (le-bucketed, ``phase`` label) — what recording rules and Grafana
    heatmaps consume; the summary family above is the human-readable
    pull-time view."""
    from .metrics import MetricFamily, _fmt_value

    fam = MetricFamily(name, "histogram")
    base = dict(labels or {})
    for phase in sorted(digests):
        d = digests[phase]
        counts, count, total, _ = d.snapshot()
        if not count:
            continue
        pl = {**base, "phase": phase}
        items = sorted(counts.items())
        acc, i = 0, 0
        for b in sorted(bounds):
            while i < len(items) and d._value_of(items[i][0]) <= b:
                acc += items[i][1]
                i += 1
            fam.add(acc, {**pl, "le": _fmt_value(b)}, "_bucket")
        fam.add(count, {**pl, "le": "+Inf"}, "_bucket")
        fam.add(total, pl, "_sum")
        fam.add(count, pl, "_count")
    return fam


class SLOConfig:
    """Latency objectives for the serving stack: ``ttft_p99_ms`` /
    ``tpot_p99_ms`` are the p99 targets (None disables a signal),
    ``window_s`` the sliding window burn is judged over. ``objective``
    is the quantile the targets name (0.99 → a 1% error budget);
    ``burn_threshold`` and ``min_samples`` define *sustained* burn:
    the flag flips only when the window holds at least ``min_samples``
    finished requests AND the burn rate is at/over the threshold —
    one slow request in an idle window is noise, not an incident."""

    def __init__(self, ttft_p99_ms=None, tpot_p99_ms=None, window_s=60.0,
                 objective=0.99, burn_threshold=1.0, min_samples=20):
        if ttft_p99_ms is None and tpot_p99_ms is None:
            raise ValueError(
                "SLOConfig needs at least one target "
                "(ttft_p99_ms= and/or tpot_p99_ms=)"
            )
        for nm, v in (("ttft_p99_ms", ttft_p99_ms),
                      ("tpot_p99_ms", tpot_p99_ms)):
            if v is not None and v <= 0:
                raise ValueError(f"{nm} must be > 0 or None, got {v}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}"
            )
        if burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}"
            )
        if min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {min_samples}"
            )
        self.ttft_p99_ms = (
            None if ttft_p99_ms is None else float(ttft_p99_ms)
        )
        self.tpot_p99_ms = (
            None if tpot_p99_ms is None else float(tpot_p99_ms)
        )
        self.window_s = float(window_s)
        self.objective = float(objective)
        self.burn_threshold = float(burn_threshold)
        self.min_samples = int(min_samples)

    @property
    def budget(self):
        """Allowed violating fraction (1 - objective)."""
        return 1.0 - self.objective


_N_SUBWINDOWS = 6


def burn_from_counts(counts, config):
    """``{signal: burn_rate_or_None}`` from pooled window counts (the
    shape :meth:`SLOTracker.window_counts` returns)."""
    out = {}
    for sig in ("ttft", "tpot"):
        target = getattr(config, f"{sig}_p99_ms")
        if target is None:
            continue
        total = counts.get(f"{sig}_total", 0)
        viol = counts.get(f"{sig}_violations", 0)
        out[sig] = (
            (viol / total) / config.budget if total else None
        )
    return out


def sustained_burn(counts, config):
    """The sustained-burn predicate over window counts: any configured
    signal at/over ``burn_threshold`` with at least ``min_samples``
    samples."""
    for sig, burn in burn_from_counts(counts, config).items():
        if (burn is not None
                and counts.get(f"{sig}_total", 0)
                >= config.min_samples
                and burn >= config.burn_threshold):
            return True
    return False


class SLOTracker:
    """Sliding-window violation accounting behind the burn gauges.

    ``record()`` is called once per finished request (host-side, a few
    comparisons + dict bumps); ``burn_rates()``/``burning()`` are
    pull-time. The window is ``_N_SUBWINDOWS`` coarse sub-buckets so
    expiry is O(1) amortized and needs no per-request timestamps."""

    def __init__(self, config):
        if not isinstance(config, SLOConfig):
            raise TypeError(
                f"SLOTracker needs an SLOConfig, got {type(config)}"
            )
        self.config = config
        self._dt = config.window_s / _N_SUBWINDOWS
        self._buckets: list = []   # [bucket_epoch, {counts}]
        self._lock = threading.Lock()

    def _now(self):
        import time

        return time.monotonic()

    def record(self, ttft_s=None, tpot_s=None, now=None):
        """Account one finished request (None skips a signal — a
        request that never produced a token has no TTFT sample)."""
        cfg = self.config
        epoch = int((now if now is not None else self._now())
                    / self._dt)
        with self._lock:
            if not self._buckets or self._buckets[-1][0] != epoch:
                self._buckets.append([epoch, {}])
                if len(self._buckets) > _N_SUBWINDOWS + 1:
                    del self._buckets[: -(_N_SUBWINDOWS + 1)]
            counts = self._buckets[-1][1]
            for sig, v, target in (
                ("ttft", ttft_s, cfg.ttft_p99_ms),
                ("tpot", tpot_s, cfg.tpot_p99_ms),
            ):
                if target is None or v is None:
                    continue
                counts[f"{sig}_total"] = (
                    counts.get(f"{sig}_total", 0) + 1
                )
                if v * 1e3 > target:
                    counts[f"{sig}_violations"] = (
                        counts.get(f"{sig}_violations", 0) + 1
                    )

    def window_counts(self, now=None):
        """Pooled counts over the live window (expired sub-buckets
        dropped)."""
        horizon = int((now if now is not None else self._now())
                      / self._dt) - _N_SUBWINDOWS
        out: dict = {}
        with self._lock:
            self._buckets = [
                b for b in self._buckets if b[0] > horizon
            ]
            for _, counts in self._buckets:
                for k, v in counts.items():
                    out[k] = out.get(k, 0) + v
        return out

    def burn_rates(self, now=None):
        """``{signal: burn}`` — burn 1.0 means the error budget is
        being spent exactly as allotted; None means no samples."""
        return burn_from_counts(self.window_counts(now), self.config)

    def burning(self, now=None):
        """Sustained burn: any configured signal at/over the threshold
        with at least ``min_samples`` window samples."""
        return sustained_burn(self.window_counts(now), self.config)
