"""Process-wide metrics registry: labeled Counter / Gauge / Histogram
(counterpart of ``paddle_tpu/observability/metrics.py``: the same API,
the same Prometheus text exposition and the same series names, so one
dashboard reads either package).

  * ``inc``/``set``/``observe`` are a lock and a float add, host-side.
  * Subsystems with their own counter structs publish as **collector
    views** (``register_collector``): nothing is written on the hot
    path, the registry PULLS a snapshot at scrape time
    (``serving.EngineMetrics``, the journal, the access log, QoS and the
    HTTP server export themselves this way).
  * ``counter()``/``gauge()``/``histogram()`` are get-or-create.
"""
from __future__ import annotations

import math
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "get_registry", "counter", "gauge", "histogram",
    "register_latency_view",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus-style default latency buckets (seconds)
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class MetricFamily:
    """One exposition unit: (name, kind, help, samples). ``samples`` is
    a list of ``(suffix, labels_dict, value)`` — suffix is "" for plain
    series, "_bucket"/"_sum"/"_count" for histogram series. Collectors
    return these; built-in metrics render themselves into them."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name, kind, help="", samples=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.samples = samples if samples is not None else []

    def add(self, value, labels=None, suffix=""):
        self.samples.append((suffix, dict(labels or {}), value))
        return self


def _fmt_value(v):
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _fmt_labels(labels):
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (
            k,
            str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"),
        )
        for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


class _Metric:
    """Shared base: name/help/label validation + per-label children."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        """Child series for one label combination (created on first
        use). With no declared labelnames, returns self."""
        if not self.labelnames:
            if labels:
                raise ValueError(f"{self.name} declares no labels")
            return self
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _series(self):
        """[(labels_dict, child)] — the unlabeled metric is its own
        single series."""
        if not self.labelnames:
            return [({}, self)]
        with self._lock:
            return [
                (dict(zip(self.labelnames, key)), child)
                for key, child in sorted(self._children.items())
            ]


class Counter(_Metric):
    """Monotonically increasing count. ``inc(amount, **labels)``."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self):
        return Counter(self.name)

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        target = self.labels(**labels) if labels else self
        with target._lock:
            target._value += amount

    @property
    def value(self):
        return self._value

    def family(self):
        fam = MetricFamily(self.name, self.kind, self.help)
        for labels, child in self._series():
            fam.add(child._value, labels)
        return fam


class Gauge(_Metric):
    """Set-to-current-value metric. ``set(v, **labels)`` / ``inc`` /
    ``dec``."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self):
        return Gauge(self.name)

    def set(self, value, **labels):
        target = self.labels(**labels) if labels else self
        with target._lock:
            target._value = float(value)

    def inc(self, amount=1, **labels):
        target = self.labels(**labels) if labels else self
        with target._lock:
            target._value += amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    @property
    def value(self):
        return self._value

    def family(self):
        fam = MetricFamily(self.name, self.kind, self.help)
        for labels, child in self._series():
            fam.add(child._value, labels)
        return fam


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each
    ``le``-bucket counts observations <= its bound, ``+Inf`` counts
    all; ``_sum``/``_count`` ride along)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self._sum = 0.0

    def _make_child(self):
        return Histogram(self.name, buckets=self.buckets)

    def observe(self, value, **labels):
        target = self.labels(**labels) if labels else self
        v = float(value)
        with target._lock:
            target._sum += v
            for i, b in enumerate(target.buckets):
                if v <= b:
                    target._counts[i] += 1
                    break
            else:
                target._counts[-1] += 1

    @property
    def count(self):
        return sum(self._counts)

    @property
    def sum(self):
        return self._sum

    def family(self):
        fam = MetricFamily(self.name, self.kind, self.help)
        for labels, child in self._series():
            with child._lock:
                counts, total = list(child._counts), child._sum
            acc = 0
            for b, c in zip(child.buckets, counts):
                acc += c
                fam.add(acc, {**labels, "le": _fmt_value(b)}, "_bucket")
            acc += counts[-1]
            fam.add(acc, {**labels, "le": "+Inf"}, "_bucket")
            fam.add(total, labels, "_sum")
            fam.add(acc, labels, "_count")
        return fam


class MetricsRegistry:
    """Named metrics + pull-time collector views.

    ``collect()`` returns MetricFamily objects (owned metrics first,
    then collector output, sorted by name); ``render_prometheus()`` is
    the text exposition; ``snapshot()`` a JSON-friendly dict keyed by
    series name + sorted labels.
    """

    def __init__(self):
        self._metrics = {}
        self._collectors = []   # [(name, fn)]
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------
    def register(self, metric):
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is not None and cur is not metric:
                raise ValueError(
                    f"metric {metric.name!r} already registered"
                )
            self._metrics[metric.name] = metric
        return metric

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            cur = self._metrics.get(name)
            if cur is not None:
                if not isinstance(cur, cls) or (
                    tuple(labelnames) != cur.labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different type or labels"
                    )
                want_buckets = kw.get("buckets")
                if (want_buckets is not None
                        and isinstance(cur, Histogram)
                        and tuple(sorted(
                            float(b) for b in want_buckets
                        )) != cur.buckets):
                    # silently handing back a different bucket layout
                    # would skew the second caller's quantiles
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different buckets"
                    )
                return cur
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def register_collector(self, name, fn):
        """Pull-time view: ``fn()`` -> iterable of MetricFamily, called
        at collect()/scrape time only — zero hot-path cost for the
        owning subsystem. ``fn`` returning None (its target is gone,
        e.g. a garbage-collected engine behind a weakref) unregisters
        itself. Re-registering a name replaces the old collector."""
        with self._lock:
            self._collectors = [
                (n, f) for n, f in self._collectors if n != name
            ]
            self._collectors.append((name, fn))

    def unregister_collector(self, name):
        with self._lock:
            self._collectors = [
                (n, f) for n, f in self._collectors if n != name
            ]

    # -- export ------------------------------------------------------------
    def collect(self):
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        fams = [m.family() for m in metrics]
        dead = []
        for name, fn in collectors:
            try:
                out = fn()
            except Exception as e:
                # one broken view must not take down the whole
                # exposition (the same per-provider isolation the
                # health snapshot applies); skipped this round, kept
                # registered — a transient (e.g. an object mid-
                # construction) recovers on the next scrape
                import sys

                sys.stderr.write(
                    f"[observability] collector {name!r} failed "
                    f"(skipped this scrape): {e!r}\n"
                )
                continue
            if out is None:
                dead.append(name)
                continue
            fams.extend(out)
        for name in dead:
            self.unregister_collector(name)
        # merge same-name families (several engines export the same
        # paddle_tpu_serving_* series under different labels): the
        # exposition must carry ONE # TYPE stanza per metric name or
        # Prometheus rejects the whole scrape
        merged: dict = {}
        for fam in fams:
            cur = merged.get(fam.name)
            if cur is None:
                merged[fam.name] = MetricFamily(
                    fam.name, fam.kind, fam.help, list(fam.samples)
                )
            else:
                cur.samples.extend(fam.samples)
                if not cur.help:
                    cur.help = fam.help
        return sorted(merged.values(), key=lambda f: f.name)

    def render_prometheus(self):
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for fam in self.collect():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for suffix, labels, value in fam.samples:
                lines.append(
                    f"{fam.name}{suffix}{_fmt_labels(labels)} "
                    f"{_fmt_value(value)}"
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self):
        """One JSON-friendly dict: series name (labels appended as
        ``{k=v,...}`` when present) -> value."""
        out = {}
        for fam in self.collect():
            for suffix, labels, value in fam.samples:
                key = fam.name + suffix
                if labels:
                    key += "{" + ",".join(
                        f"{k}={v}" for k, v in sorted(labels.items())
                    ) + "}"
                out[key] = value
        return out


def register_latency_view(name, fn, prefix, labels=None,
                          quantiles=None, registry=None):
    """The digest collector-view kind: register a pull-time view over
    mergeable :class:`~.latency.LatencyDigest`
    sketches. ``fn()`` returns ``{phase: LatencyDigest}`` — evaluated
    at scrape time only (zero hot-path registry cost, the same
    contract as ``register_collector``) — and the view renders TWO
    exposition families from it:

      * ``<prefix>_seconds`` — a quantile-labeled summary
        (``{phase=...,quantile=...}`` series plus ``_sum``/``_count``)
      * ``<prefix>_hist_seconds`` — a Prometheus-native cumulative
        histogram (``le``-bucketed) for recording rules and heatmaps

    ``fn`` returning None unregisters the view (the weakref-collector
    idiom). The serving engine registers its per-request phase digests
    this way, and QoS one view per tenant under the same prefix."""
    from .latency import (
        DEFAULT_QUANTILES, histogram_family, summary_family,
    )

    reg = registry or _default
    qs = tuple(quantiles) if quantiles is not None else DEFAULT_QUANTILES
    base = dict(labels or {})

    def collect():
        digests = fn()
        if digests is None:
            return None
        fams = []
        fam = summary_family(
            f"{prefix}_seconds", digests, base, quantiles=qs
        )
        if fam.samples:
            fams.append(fam)
        fam = histogram_family(f"{prefix}_hist_seconds", digests, base)
        if fam.samples:
            fams.append(fam)
        return fams

    reg.register_collector(name, collect)


_default = MetricsRegistry()


def get_registry():
    """The process-wide default registry (what the scrape endpoint and
    flight recorder export)."""
    return _default


def counter(name, help="", labelnames=()):
    """Get-or-create a Counter on the default registry."""
    return _default.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    """Get-or-create a Gauge on the default registry."""
    return _default.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    """Get-or-create a Histogram on the default registry."""
    return _default.histogram(name, help, labelnames, buckets=buckets)
