"""Always-on telemetry for the serving front door (counterpart of
``paddle_tpu.observability``, cut to what the serving path uses; its CLI,
``python -m paddle_tpu_torch.observability dump|metrics|slo|top``, is
``__main__.py``):

  * **metrics** — a process-wide registry of labeled
    Counter/Gauge/Histogram with Prometheus text exposition and a JSON
    snapshot; subsystems with their own counter structs (the engine, the
    journal, the access log, QoS, the HTTP server) publish as pull-time
    collector views, so the hot path writes nothing.
  * **latency** — mergeable latency digests and SLO error-budget burn.
  * **spans** — trace/span ids, continued from an inbound
    ``traceparent`` and recorded on every request.
  * **flight recorder** — a bounded ring of recent events, finished
    request timelines and serving step samples, dumped with the compile
    log to a postmortem JSON file on demand, on an engine error or on
    SIGUSR2.
  * **jit_events** — the compile log: one event per program capture,
    and the retrace-after-warmup alarm.
  * **stepstats** — the serving step observatory: per-program launch
    walls, host overhead, the goodput ledger and MFU.
  * **scrape** — ``/metrics`` and ``/healthz`` on a thread, and the HTTP
    host the serving front door builds on.
"""
from . import flight, jit_events, latency, metrics, scrape, spans, stepstats
from .flight import (
    FlightRecorder,
    dump,
    find_dumps,
    get_flight_recorder,
    install_signal_handler,
    record,
)
from .latency import LatencyDigest, SLOConfig, SLOTracker
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricFamily,
    MetricsRegistry,
    counter,
    gauge,
    get_registry,
    histogram,
    register_latency_view,
)
from .scrape import (
    ScrapeServer,
    health_snapshot,
    register_health_provider,
    start_scrape_server,
    unregister_health_provider,
)
from .spans import (
    Span,
    current_span,
    current_trace_id,
    current_traceparent,
    export_chrome_trace,
    finished_spans,
    remote_span,
    span,
)
from .stepstats import StepStats, register_stepstats_view

__all__ = [
    # metrics
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "counter", "gauge", "histogram", "get_registry",
    "register_latency_view",
    # latency digests + SLO burn
    "LatencyDigest", "SLOConfig", "SLOTracker",
    # spans
    "Span", "span", "remote_span", "current_span", "current_trace_id",
    "current_traceparent", "finished_spans", "export_chrome_trace",
    # flight recorder
    "FlightRecorder", "get_flight_recorder", "record", "dump",
    "find_dumps", "install_signal_handler",
    # scrape endpoint
    "ScrapeServer", "start_scrape_server", "register_health_provider",
    "unregister_health_provider", "health_snapshot",
    # serving step observatory
    "StepStats", "register_stepstats_view",
    # submodules
    "flight", "jit_events", "latency", "metrics", "scrape", "spans",
    "stepstats",
]
