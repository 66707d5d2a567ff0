"""Optional scrape endpoint: ``/metrics`` + ``/healthz`` on a thread
(counterpart of ``paddle_tpu/observability/scrape.py``).

One background ``ThreadingHTTPServer`` makes the process observable to
a standard Prometheus scraper and a load-balancer health check without
any framework dependency:

  * ``GET /metrics``  — the default registry's text exposition
  * ``GET /healthz``  — JSON aggregation of registered health
    providers (``serving.Engine`` registers its ``health()`` snapshot
    automatically); HTTP 200 when every provider reports ``status:
    "ok"``, 503 otherwise (a degraded/overloaded replica should be
    rotated out, not sent more traffic)

Export failures fire the ``obs.export`` fault site and degrade to an
HTTP 500 plus a logged warning — a broken exporter must never crash
(or stall) the serving loop it is observing.
"""
from __future__ import annotations

import json
import sys
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import metrics as _metrics

__all__ = [
    "ScrapeServer", "start_scrape_server",
    "register_health_provider", "unregister_health_provider",
    "health_snapshot", "ThreadedHTTPHost", "ObservabilityHandler",
]

_providers_lock = threading.Lock()
_providers: dict = {}   # name -> callable() -> dict | None


def register_health_provider(name, fn):
    """Attach a health snapshot callable (e.g. a weakref closure over
    ``Engine.health``). A provider returning None — its target was
    garbage-collected — is pruned at the next snapshot."""
    with _providers_lock:
        _providers[name] = fn


def unregister_health_provider(name):
    with _providers_lock:
        _providers.pop(name, None)


def health_snapshot():
    """Aggregate provider snapshots: overall ``status`` is "ok" only
    when every live provider says so (no providers -> "ok": a process
    serving nothing is healthy)."""
    with _providers_lock:
        items = list(_providers.items())
    out = {"status": "ok", "providers": {}}
    dead = []
    for name, fn in items:
        try:
            snap = fn()
        except Exception as e:  # one broken probe must not 503 the rest
            snap = {"status": "degraded", "error": repr(e)}
        if snap is None:
            dead.append(name)
            continue
        out["providers"][name] = snap
        status = snap.get("status", "ok") if isinstance(snap, dict) else "ok"
        if status != "ok" and out["status"] == "ok":
            out["status"] = str(status)
    if dead:
        with _providers_lock:
            for name in dead:
                _providers.pop(name, None)
    return out


class ObservabilityHandler(BaseHTTPRequestHandler):
    """Base request handler carrying the ``/metrics`` + ``/healthz``
    routes. The API front door (``serving/server.py``) subclasses this
    to co-host the observability endpoints next to the inference API
    without re-implementing the exporter degradation contract."""

    def log_message(self, fmt, *args):  # quiet: CI logs, not access logs
        return

    def _send(self, code, body, ctype, headers=None):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _serve_observability(self, path):
        """Serve ``/metrics`` / ``/healthz``; return False for other
        paths (a subclass routes those itself)."""
        from ..resilience import faults

        if path == "/metrics":
            faults.fire("obs.export", what="scrape", path=path)
            registry = (
                getattr(self.server, "registry", None)
                or _metrics.get_registry()
            )
            body = registry.render_prometheus()
            self._send(
                200, body, "text/plain; version=0.0.4; charset=utf-8"
            )
        elif path == "/healthz":
            faults.fire("obs.export", what="healthz", path=path)
            snap = health_snapshot()
            code = 200 if snap["status"] == "ok" else 503
            self._send(code, json.dumps(snap), "application/json")
        else:
            return False
        return True

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        try:
            if not self._serve_observability(path):
                self._send(404, "not found\n", "text/plain")
        except Exception as e:
            # exporter degradation contract: warn + 500, never propagate
            sys.stderr.write(
                f"[observability] scrape of {path} failed (degraded): "
                f"{e!r}\n"
            )
            try:
                self._send(500, "scrape failed\n", "text/plain")
            except OSError:
                pass  # peer already gone; nothing left to degrade to


class _ThreadingHTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets connections
    # of a burst of concurrent clients (the JAX package's host keeps
    # that default)
    request_queue_size = 128
    daemon_threads = True


class ThreadedHTTPHost:
    """Shared ``ThreadingHTTPServer``-on-a-daemon-thread setup: bind
    (``port=0`` picks a free port — read ``.port``), attach arbitrary
    attributes to the httpd for handlers to reach via ``self.server``,
    and serve until ``close()``. ``ScrapeServer`` and the serving
    front door both build on this."""

    thread_name = "paddle_tpu-http"
    handler_cls = ObservabilityHandler

    def __init__(self, host="127.0.0.1", port=0, handler_cls=None,
                 **server_attrs):
        self._httpd = _ThreadingHTTPServer(
            (host, port), handler_cls or self.handler_cls
        )
        for k, v in server_attrs.items():
            setattr(self._httpd, k, v)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=self.thread_name,
        )
        self._thread.start()

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ScrapeServer(ThreadedHTTPHost):
    """Handle to the running endpoint (``.port``, ``.url``,
    ``.close()``)."""

    thread_name = "paddle_tpu-scrape"

    def __init__(self, host="127.0.0.1", port=0, registry=None):
        super().__init__(
            host=host, port=port,
            registry=registry or _metrics.get_registry(),
        )


def start_scrape_server(port=0, host="127.0.0.1", registry=None):
    """Start the `/metrics` + `/healthz` thread (``port=0`` picks a
    free port — read it off the returned server). Also installs the
    SIGUSR2 flight-dump handler: a scraped process is a production
    process, so give operators the postmortem trigger too."""
    from . import flight

    flight.install_signal_handler()
    return ScrapeServer(host=host, port=port, registry=registry)
