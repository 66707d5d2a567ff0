"""Streaming HTTP front door for the serving engine (counterpart of
``paddle_tpu/serving/server.py``, the same wire format, errors and
series).

An OpenAI-style ``POST /v1/completions`` endpoint over a ``Fleet`` or a
single ``Engine``, on the stdlib ``ThreadingHTTPServer`` the
observability scrape endpoint uses (``ThreadedHTTPHost``; no framework
dependency):

  * **Streaming** — ``"stream": true`` responds as Server-Sent Events:
    one ``data: {...}`` chunk per token batch (the handler watches
    ``Request.output_token_ids`` grow past its cursor), a final chunk
    carrying ``finish_reason`` + usage, then ``data: [DONE]``. Greedy
    streams carry the tokens of in-process ``generate()``.
  * **Non-streaming** — one JSON completion body at finish.
  * **Validation** — malformed requests answer structured 4xx JSON
    (``{"error": {"type", "message", "param"}}``), never a stack
    trace; the offending field is named when known.
  * **Multi-tenant QoS** (``serving/qos.py``) — tenant identity from
    ``Authorization: Bearer``/``X-Tenant``, quota / token-rate /
    sustained-burn shedding as 429 + ``Retry-After``, weighted
    fair-share dispatch over a fleet's pending queue, per-tenant
    latency/SLO series on the co-hosted ``/metrics``.
  * **Co-hosting** — ``GET /metrics`` + ``GET /healthz`` answer on the
    same port.
  * **Degradation** — the fault sites ``http.accept`` (request accept)
    and ``http.stream`` (per-chunk stream write) plus client disconnects
    degrade to a counted, warn-once abort of THAT request. A step that
    raises is counted and retried, as in the JAX package, except a
    device fault (``torch.AcceleratorError``): a CUDA error inside a
    graph replay is sticky, so the driver stops stepping, every
    in-flight request finishes with ``"error"`` (a 500, or a final SSE
    chunk saying so), new requests answer 503 ``backend_failed`` and
    ``/healthz`` reports ``failed`` — the fault is never hidden behind
    retries (a fleet re-raises it too, instead of failing a replica
    over).
  * **Drain** — SIGTERM (or :meth:`Server.drain`) stops admitting (503
    ``server_draining``), lets in-flight streams finish, then closes the
    listener.

One driver thread steps the backend (and so captures its programs on
first use); handler threads only submit, watch token growth, and write
bytes — the engine never runs on a client's thread.
"""
from __future__ import annotations

import itertools
import json
import math
import threading
import time
import warnings
import weakref

from ..observability import metrics as _obs_metrics
from ..observability.scrape import (
    ObservabilityHandler, ThreadedHTTPHost, register_health_provider,
    unregister_health_provider,
)
from ..observability.spans import remote_span, span
from ..resilience import faults
from .engine import _DEVICE_FAULTS, EngineOverloadedError
from .qos import QoS, QoSConfig, QoSRejection, UnknownTenantError
from .request import Request, RequestOutput, SamplingParams

__all__ = ["Server", "serve"]

_server_counter = itertools.count(1)

# SamplingParams fields accepted on the wire (plus the OpenAI-style
# "max_tokens" alias); anything else in the body is ignored for
# forward compatibility — EXCEPT unknown sampling of known fields,
# which SamplingParams validates by name
_SAMPLING_FIELDS = (
    "max_new_tokens", "do_sample", "temperature", "top_k", "top_p",
    "eos_token_id", "stop_token_ids", "ttl_s", "seed",
)

_RESPONSE_CLASSES = ("2xx", "3xx", "4xx", "5xx")


def _parse_traceparent(header):
    """W3C ``traceparent`` (``00-<32hex trace>-<16hex span>-<flags>``)
    -> this repo's ``"<trace_id>-<span_id>"`` propagation string; None
    for a missing/malformed header (the caller then mints a fresh
    trace root, so every admitted request carries SOME trace id into
    the access log)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace, parent, _flags = parts
    if len(trace) != 32 or len(parent) != 16 or len(version) != 2:
        return None
    try:
        int(version, 16), int(trace, 16), int(parent, 16)
    except ValueError:
        return None
    if trace == "0" * 32 or parent == "0" * 16:
        return None
    return f"{trace}-{parent}"


class _ServerMetrics:
    """Plain-attribute counters for the HTTP layer, exported at pull
    time by a weakref collector view (the EngineMetrics pattern)."""

    def __init__(self, server_id):
        self.requests = 0          # POST /v1/completions accepted
        self.streams = 0           # of which streaming
        self.responses = {c: 0 for c in _RESPONSE_CLASSES}
        self.shed_429 = 0          # QoS/overload rejections
        self.disconnects = 0       # mid-stream client hangups
        self.accept_faults = 0     # http.accept degradations
        self.stream_faults = 0     # http.stream degradations
        self.step_errors = 0       # backend stepping degradations
        self.device_faults = 0     # of which device faults (fatal)
        self.active_streams = 0    # gauge
        self.draining = False
        _register_server_view(self, server_id)

    def count_response(self, code):
        cls = f"{code // 100}xx"
        if cls in self.responses:
            self.responses[cls] += 1


def _register_server_view(m, server_id):
    try:
        from ..observability import MetricFamily, get_registry
    except Exception:
        # observability is optional here
        return
    ref = weakref.ref(m)
    label = {"server": server_id}

    def collect():
        sm = ref()
        if sm is None:
            return None
        fams = [
            MetricFamily(
                "paddle_tpu_serving_http_requests_total", "counter",
            ).add(sm.requests, label),
            MetricFamily(
                "paddle_tpu_serving_http_streams_total", "counter",
            ).add(sm.streams, label),
            MetricFamily(
                "paddle_tpu_serving_http_shed_total", "counter",
            ).add(sm.shed_429, label),
            MetricFamily(
                "paddle_tpu_serving_http_disconnects_total", "counter",
            ).add(sm.disconnects, label),
            MetricFamily(
                "paddle_tpu_serving_http_accept_faults_total", "counter",
            ).add(sm.accept_faults, label),
            MetricFamily(
                "paddle_tpu_serving_http_stream_faults_total", "counter",
            ).add(sm.stream_faults, label),
            MetricFamily(
                "paddle_tpu_serving_http_step_errors_total", "counter",
            ).add(sm.step_errors, label),
            MetricFamily(
                "paddle_tpu_serving_http_device_faults_total", "counter",
            ).add(sm.device_faults, label),
            MetricFamily(
                "paddle_tpu_serving_http_active_streams", "gauge",
            ).add(sm.active_streams, label),
            MetricFamily(
                "paddle_tpu_serving_http_draining", "gauge",
            ).add(1.0 if sm.draining else 0.0, label),
        ]
        resp = MetricFamily(
            "paddle_tpu_serving_http_responses_total", "counter",
        )
        for cls, n in sm.responses.items():
            resp.add(n, {**label, "class": cls})
        fams.append(resp)
        return fams

    try:
        get_registry().register_collector(
            f"serving.server.{server_id}", collect
        )
    except Exception:
        # telemetry is best-effort
        pass


class _ApiError(Exception):
    """Internal signal mapped to one structured HTTP error body."""

    def __init__(self, code, err_type, message, param=None,
                 retry_after=None):
        self.code = code
        self.err_type = err_type
        self.message = message
        self.param = param
        self.retry_after = retry_after
        super().__init__(message)

    def body(self):
        err = {"type": self.err_type, "message": self.message}
        if self.param is not None:
            err["param"] = self.param
        return {"error": err}


def _param_from_message(msg):
    """Best-effort offending-field extraction: SamplingParams (and the
    prompt checks) open their ValueError messages with the field
    name."""
    head = str(msg).split(" ", 1)[0]
    if head in _SAMPLING_FIELDS or head in ("prompt", "prompt_token_ids"):
        return "prompt" if head == "prompt_token_ids" else head
    return None


class _Stream:
    """One in-flight HTTP request: the engine-side Request plus the
    completion event the waiting handler blocks on."""

    __slots__ = ("req", "tenant", "done", "output", "streaming")

    def __init__(self, req, tenant, streaming):
        self.req = req
        self.tenant = tenant
        self.streaming = streaming
        self.done = threading.Event()
        self.output = None


class _ApiHandler(ObservabilityHandler):
    """Routes: POST /v1/completions (the API), GET /metrics +
    /healthz (inherited). Handler threads never step the engine."""

    def do_POST(self):
        api = self.server.api
        path = self.path.split("?", 1)[0]
        if path != "/v1/completions":
            self._send_json(404, {"error": {
                "type": "invalid_request_error",
                "message": f"no such endpoint: {path}",
            }})
            return
        try:
            api.handle_completion(self)
        except Exception as e:
            # the HTTP degradation contract: a handler failure answers
            # 500 (when the response line is still writable) and is
            # counted — never propagated into the serving process
            api.metrics.accept_faults += 1
            api.warn_once(
                "accept",
                f"[server] request handling failed (degraded): {e!r}",
            )
            try:
                self._send_json(500, {"error": {
                    "type": "internal_error",
                    "message": f"{type(e).__name__}: {e}",
                }})
            except OSError:
                pass  # peer already gone; nothing left to degrade to

    def _send_json(self, code, obj, headers=None):
        self.server.api.metrics.count_response(code)
        self._send(
            code, json.dumps(obj), "application/json", headers=headers
        )


class Server(ThreadedHTTPHost):
    """The HTTP front door. ``backend`` is a ``Fleet`` or a single
    ``Engine`` (on the card, or on the CPU when its model is); ``qos`` a
    :class:`~.qos.QoS`,
    :class:`~.qos.QoSConfig` or None (default policy: one shared tenant,
    no limits). ``port=0`` binds an ephemeral port (read
    ``.port``/``.url``). ``poll_interval_s``: the driver's pause after a
    step that finished no request, so handler threads can take the GIL
    to write their chunks. The JAX package's knob; its default there is
    0.002 s, here 0: on an H100 a replayed decode step takes ~2.3 ms, and
    the serving cell over HTTP ran at 0.55x of in-process ``generate``
    with the pause against 0.83x without it (``chip_smoke.py`` server
    phase, NVIDIA H100 80GB HBM3 at 700 W; PERF.md)."""

    thread_name = "paddle_tpu-http-api"
    handler_cls = _ApiHandler

    def __init__(self, backend, host="127.0.0.1", port=0, qos=None,
                 registry=None, drain_timeout_s=30.0,
                 poll_interval_s=0.0):
        from .fleet import Fleet

        self.backend = backend
        self._is_fleet = isinstance(backend, Fleet)
        if isinstance(qos, QoS):
            self.qos = qos
        else:
            self.qos = QoS(qos if isinstance(qos, QoSConfig) else None)
        if self._is_fleet:
            self.qos.attach(backend)
        self.server_id = f"{next(_server_counter)}"
        self.metrics = _ServerMetrics(self.server_id)
        self.drain_timeout_s = float(drain_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self._draining = False
        self._closed = False
        self._failed = None               # the device fault, once fatal
        self._warned: set = set()
        self._streams: dict = {}          # rid -> _Stream
        # ONE lock serializes every backend call (submit/step/abort):
        # engines are stepped from the driver thread, handlers only
        # enqueue/abort under the same lock
        self._backend_lock = threading.Lock()
        # signaled after every step so streaming handlers wake to new
        # tokens, and whenever work arrives so the driver wakes
        self._progress = threading.Condition()
        super().__init__(
            host=host, port=port,
            registry=registry or _obs_metrics.get_registry(),
            api=self,
        )
        self._driver = threading.Thread(
            target=self._step_loop, daemon=True,
            name=f"paddle_tpu-http-driver-{self.server_id}",
        )
        self._driver.start()

        def _probe(ref=weakref.ref(self)):
            srv = ref()
            if srv is None:
                return None
            status = "draining" if srv._draining else "ok"
            if srv._failed is not None:
                status = "failed"
            return {
                "status": status,
                "active_streams": len(srv._streams),
                "port": srv.port,
                "error": srv._failed,
            }

        register_health_provider(
            f"serving.server.{self.server_id}", _probe
        )

    # -- lifecycle -----------------------------------------------------------
    def warn_once(self, key, message):
        if key in self._warned:
            return
        self._warned.add(key)
        warnings.warn(message, stacklevel=2)

    def drain(self, timeout=None):
        """Stop admitting (new completions answer 503
        ``server_draining``), wait for in-flight requests to finish.
        Returns True when everything drained inside ``timeout``
        (default ``drain_timeout_s``)."""
        # GIL-atomic one-way bool flip; racing writers all write True
        self._draining = True
        self.metrics.draining = True
        deadline = time.monotonic() + (
            self.drain_timeout_s if timeout is None else float(timeout)
        )
        while self._streams and time.monotonic() < deadline:
            time.sleep(0.01)
        return not self._streams

    def install_signal_handlers(self):
        """SIGTERM -> graceful drain then close (main thread only;
        the CLI entry point calls this)."""
        import signal

        def _on_term(signum, frame):
            t = threading.Thread(
                target=self._drain_and_close, daemon=True,
                name="paddle_tpu-http-drain",
            )
            t.start()

        signal.signal(signal.SIGTERM, _on_term)

    def _drain_and_close(self):
        self.drain()
        self.close()

    def close(self):
        if self._closed:
            return
        # one-way bool flip; a racing duplicate close is idempotent
        self._closed = True
        with self._progress:
            self._progress.notify_all()
        unregister_health_provider(f"serving.server.{self.server_id}")
        super().close()
        self._driver.join(timeout=5.0)

    # -- backend driving -----------------------------------------------------
    def _step_loop(self):
        """The single thread that steps the backend while any HTTP
        request is in flight. Stepping failures degrade (warn-once +
        counter + pause) — the driver must outlive any injected or
        transient backend error — except a device fault, which ends
        the driver (:meth:`_fail`)."""
        while not self._closed:
            if not self._streams:
                with self._progress:
                    if not self._streams and not self._closed:
                        self._progress.wait(0.05)
                continue
            try:
                with self._backend_lock:
                    outs = self.backend.step()
            except Exception as e:
                # the degradation contract: the HTTP layer must never be
                # fatal to — or killed by — the engine it fronts
                self.metrics.step_errors += 1
                if isinstance(e, _DEVICE_FAULTS):
                    self._fail(e)
                    return
                self.warn_once(
                    "step",
                    f"[server] backend step failed (degraded): {e!r}",
                )
                time.sleep(0.05)
                outs = []
            for out in outs:
                self._finish_stream(out)
            with self._progress:
                self._progress.notify_all()
            if not outs:
                # requests in flight but nothing finished this step;
                # yield briefly so handler threads can drain tokens
                time.sleep(self.poll_interval_s)

    def _fail(self, exc):
        """A device fault: stop stepping for good, finish every
        in-flight request with ``"error"`` and refuse new ones (503
        ``backend_failed``); ``/healthz`` says ``failed``."""
        self.metrics.device_faults += 1
        self._failed = f"{type(exc).__name__}: {exc}"
        warnings.warn(
            f"[server] device fault in a backend step; serving stopped: "
            f"{exc!r}", stacklevel=2,
        )
        with self._backend_lock:
            streams = list(self._streams.values())
        for stream in streams:
            req = stream.req
            req.finish_reason, req.error = "error", self._failed
            self._finish_stream(RequestOutput(req))
        with self._progress:
            self._progress.notify_all()

    def _check_failed(self):
        if self._failed is not None:
            raise _ApiError(
                503, "backend_failed",
                f"the engine stopped on a device fault: {self._failed}",
            )

    def _finish_stream(self, out):
        stream = self._streams.pop(out.request_id, None)
        if stream is None:
            return  # in-process caller's request (shared backend)
        self.metrics.active_streams = len(self._streams)
        self.qos.on_finish(stream.req)
        stream.output = out
        stream.done.set()

    def _submit(self, prompt, params, tenant):
        """Admission under the backend lock; returns the new _Stream.
        Raises _ApiError for every refusal. The QoS check and the
        backend admission share the lock so they are ATOMIC —
        otherwise N concurrent handlers could all pass the quota
        check before any of them is accounted inflight."""
        with self._backend_lock:
            self._check_failed()   # under the lock: _fail snapshots it
            try:
                backlog, capacity = self._backlog()
                self.qos.try_admit(
                    tenant, params.max_new_tokens,
                    backlog=backlog, capacity=capacity,
                )
            except QoSRejection as e:
                raise _ApiError(
                    429, "rate_limit_error", str(e),
                    retry_after=e.retry_after,
                )
            try:
                if self._is_fleet:
                    req = self.backend.add_request(
                        prompt, params, tenant=tenant).request
                else:
                    req = Request(prompt, params)
                    req.tenant = tenant
                    self.backend.submit(req)
            except EngineOverloadedError as e:
                self.qos.count_queue_shed(tenant)
                raise _ApiError(
                    429, "overloaded_error", str(e), retry_after=1.0
                )
            except RuntimeError as e:
                # engine bounded admission queue (max_waiting), or a
                # fleet with no live replica
                self.qos.count_queue_shed(tenant)
                raise _ApiError(
                    429, "overloaded_error", str(e), retry_after=1.0
                )
            except ValueError as e:
                raise _ApiError(
                    400, "invalid_request_error", str(e),
                    param=_param_from_message(e),
                )
            stream = _Stream(req, tenant, streaming=False)
            self._streams[req.request_id] = stream
            self.metrics.active_streams = len(self._streams)
            if not self._is_fleet:
                # the fleet's add_request already accounted the
                # admission. Still under the lock: the accounting must
                # land before the next handler's quota check runs
                self.qos.on_admit(req)
        with self._progress:
            self._progress.notify_all()
        return stream

    def _abort(self, rid):
        with self._backend_lock:
            self.backend.abort(rid)

    def _backlog(self):
        """(live backlog, capacity-or-None) for burn-first shedding."""
        b = self.backend
        if self._is_fleet:
            return sum(not f.done for f in b._pending), b.config.max_pending
        return len(b.waiting), b.config.max_waiting

    # -- request handling ----------------------------------------------------
    def handle_completion(self, handler):
        self.metrics.requests += 1
        try:
            faults.fire(
                "http.accept", path="/v1/completions",
                client=handler.client_address[0],
            )
        except Exception as e:
            # injected accept fault: count + structured 500, never fatal
            # to the engine
            self.metrics.accept_faults += 1
            self.warn_once(
                "http.accept",
                f"[server] http.accept fault (degraded): {e!r}",
            )
            handler._send_json(500, {"error": {
                "type": "internal_error",
                "message": f"accept failed: {type(e).__name__}: {e}",
            }})
            return
        try:
            stream, body = self._admit(handler)
        except _ApiError as e:
            headers = {}
            if e.retry_after is not None:
                headers["Retry-After"] = str(
                    max(1, int(math.ceil(e.retry_after)))
                )
                self.metrics.shed_429 += 1
            handler._send_json(e.code, e.body(), headers=headers)
            return
        if stream.streaming:
            self.metrics.streams += 1
            self._stream_response(handler, stream)
        else:
            self._blocking_response(handler, stream)

    def _admit(self, handler):
        """Parse + validate + QoS-admit one POST body; returns the
        registered _Stream. Every refusal raises _ApiError."""
        self._check_failed()
        if self._draining:
            raise _ApiError(
                503, "server_draining",
                "server is draining; retry against another replica",
                retry_after=1.0,
            )
        try:
            length = int(handler.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = 0
        raw = handler.rfile.read(length) if length > 0 else b""
        try:
            body = json.loads(raw.decode() or "null")
        except (ValueError, UnicodeDecodeError):
            raise _ApiError(
                400, "invalid_request_error",
                "request body is not valid JSON",
            )
        if not isinstance(body, dict):
            raise _ApiError(
                400, "invalid_request_error",
                "request body must be a JSON object",
            )
        try:
            tenant = self.qos.resolve(handler.headers)
        except UnknownTenantError as e:
            raise _ApiError(401, "authentication_error", str(e))
        prompt = body.get("prompt", body.get("prompt_token_ids"))
        if (not isinstance(prompt, list) or not prompt or any(
                isinstance(t, bool) or not isinstance(t, int)
                for t in prompt)):
            raise _ApiError(
                400, "invalid_request_error",
                "prompt must be a non-empty list of token ids "
                "(this API is tokenizer-less)",
                param="prompt",
            )
        streaming = body.get("stream", False)
        if not isinstance(streaming, bool):
            raise _ApiError(
                400, "invalid_request_error",
                f"stream must be a boolean, got {streaming!r}",
                param="stream",
            )
        kw = {}
        if "max_tokens" in body:      # OpenAI-style alias
            kw["max_new_tokens"] = body["max_tokens"]
        for f in _SAMPLING_FIELDS:
            if f in body:
                kw[f] = body[f]
        try:
            params = SamplingParams(**kw)
        except (ValueError, TypeError) as e:
            raise _ApiError(
                400, "invalid_request_error", str(e),
                param=_param_from_message(e),
            )
        # trace propagation: an inbound W3C traceparent continues the
        # caller's trace; without one a fresh root is minted. Either
        # way the span is open across Request creation, so
        # Request.trace_id (and thus the access-log "trace" field)
        # carries the distributed trace id
        tp = _parse_traceparent(handler.headers.get("traceparent"))
        ctx = (
            remote_span("http.completion", tp, tenant=tenant)
            if tp is not None
            else span("http.completion", tenant=tenant)
        )
        with ctx:
            stream = self._submit(prompt, params, tenant)
        stream.streaming = streaming
        return stream, body

    # -- responses -----------------------------------------------------------
    def _completion_body(self, stream, out):
        n_prompt = len(stream.req.prompt_token_ids)
        n_out = len(out.token_ids)
        return {
            "id": str(out.request_id),
            "object": "text_completion",
            "tenant": stream.tenant,
            "choices": [{
                "index": 0,
                "token_ids": list(out.token_ids),
                "finish_reason": out.finish_reason,
            }],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_out,
                "total_tokens": n_prompt + n_out,
            },
        }

    def _blocking_response(self, handler, stream):
        while not stream.done.wait(0.05):
            if self._closed:
                handler._send_json(503, {"error": {
                    "type": "server_draining",
                    "message": "server closed mid-request",
                }})
                return
        out = stream.output
        rid_headers = {"x-request-id": str(stream.req.request_id)}
        if out.finish_reason == "error":
            handler._send_json(500, {"error": {
                "type": "internal_error",
                "message": out.error or "request errored",
            }}, headers=rid_headers)
            return
        handler._send_json(
            200, self._completion_body(stream, out), headers=rid_headers
        )

    def _stream_response(self, handler, stream):
        """SSE: chunks of new token ids as they land (the handler's
        cursor over ``output_token_ids`` — the EMIT-cursor idiom at
        the wire), a final chunk with finish_reason + usage, then
        ``[DONE]``. A write failure (client gone, injected
        ``http.stream`` fault) aborts THIS request and nothing
        else."""
        rid = stream.req.request_id
        self.metrics.count_response(200)
        try:
            handler.send_response(200)
            handler.send_header(
                "Content-Type", "text/event-stream; charset=utf-8"
            )
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            handler.send_header("x-request-id", str(rid))
            handler.end_headers()
        except OSError:
            self._client_gone(stream)
            return
        cursor = 0
        seq = 0
        try:
            while True:
                done = stream.done.is_set()
                toks = stream.req.output_token_ids
                if len(toks) > cursor:
                    chunk = list(toks[cursor:])
                    cursor += len(chunk)
                    seq += 1
                    faults.fire(
                        "http.stream", rid=str(rid), seq=seq,
                    )
                    self._write_event(handler, {
                        "id": str(rid),
                        "object": "text_completion.chunk",
                        "choices": [{
                            "index": 0,
                            "token_ids": chunk,
                            "finish_reason": None,
                        }],
                    })
                if done:
                    break
                if self._closed:
                    return
                with self._progress:
                    self._progress.wait(0.05)
            out = stream.output
            final = self._completion_body(stream, out)
            final["object"] = "text_completion.chunk"
            self._write_event(handler, final)
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            self._client_gone(stream)
        except Exception as e:
            # injected http.stream fault or serializer failure: degrade
            # to aborting THIS stream; the engine and every other stream
            # keep going
            self.metrics.stream_faults += 1
            self.warn_once(
                "http.stream",
                f"[server] stream write failed (degraded): {e!r}",
            )
            if not stream.done.is_set():
                self._abort(rid)

    def _write_event(self, handler, obj):
        handler.wfile.write(
            b"data: " + json.dumps(obj).encode() + b"\n\n"
        )
        handler.wfile.flush()

    def _client_gone(self, stream):
        """Mid-stream disconnect: abort the request so its slot frees
        on the next step (no slot leak for a dead client)."""
        self.metrics.disconnects += 1
        if not stream.done.is_set():
            self._abort(stream.req.request_id)


def serve(backend, host="127.0.0.1", port=8000, qos=None,
          registry=None):
    """Convenience wrapper: build a :class:`Server`, install the
    SIGTERM drain handler, return the server (non-blocking — callers
    own the foreground wait)."""
    srv = Server(
        backend, host=host, port=port, qos=qos, registry=registry
    )
    try:
        srv.install_signal_handlers()
    except ValueError:
        # not the main thread (tests): signals stay uninstalled
        pass
    return srv
