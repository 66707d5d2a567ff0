"""The port's HTTP front door (``paddle_tpu_torch.serving.server``, ``qos``
and the CLI) on the CPU, against the JAX package's ``Server`` over a JAX
``Engine`` on the same weights (the reference engine with the analysis
gate off):

  * blocking bodies (token ids, usage, finish_reason) and the SSE chunks'
    token ids are the JAX server's and in-process ``generate``'s;
  * the malformed-request table answers the same codes, error types,
    params and messages; 404 and 401 too;
  * a tenant quota sheds 429 with ``Retry-After`` and per-tenant series;
    the weighted fair-share order of ``QoS.select`` is JAX's (3:1
    interleaves);
  * a mid-stream disconnect aborts that request and leaks no slot; the
    ``http.accept`` and ``http.stream`` faults degrade one request; drain
    finishes the in-flight stream, then 503; a device fault in a step
    fails the in-flight requests and the server instead of retrying,
    over an engine and over a fleet;
  * a 2-replica ``Fleet`` behind the server: QoS attached to the fleet,
    two tenants' blocking and SSE requests each answered once with the
    in-process tokens, ``/healthz`` listing both replicas;
  * the CLI's named config errors, its refusals of unported flags,
    ``--replicas 2`` building a 2-replica fleet, and SIGTERM draining a
    ``python -m paddle_tpu_torch.serving serve --device cpu`` process.
"""
import http.client
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving.qos import QoS as JaxQoS
from paddle_tpu.serving.qos import QoSConfig as JaxQoSConfig
from paddle_tpu.serving.qos import TenantPolicy as JaxTenantPolicy
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.observability import SLOConfig
from paddle_tpu_torch.resilience import FaultSpec, faults
from paddle_tpu_torch.serving import (
    QoS,
    QoSConfig,
    Request,
    SamplingParams,
    Server,
    TenantPolicy,
)
from paddle_tpu_torch.serving import Engine, EngineConfig, Fleet, FleetConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [1, 2, 3]
N_NEW = 8
GEO = dict(max_batch_slots=4, max_model_len=32, page_size=4,
           prefill_buckets=[32])


@pytest.fixture(scope="module")
def twins():
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny())
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return jax_model, port


@pytest.fixture(scope="module")
def servers(twins):
    """The port's server over the port's engine, and the JAX server over
    the JAX engine, same weights and geometry."""
    jax_model, port = twins
    engine = Engine(port, EngineConfig(**GEO))
    jengine = jax_serving.Engine(jax_model, jax_serving.EngineConfig(
        **GEO, analysis_check=None))
    mine, theirs = Server(engine, port=0), jax_serving.Server(jengine,
                                                              port=0)
    yield mine, theirs
    mine.close()
    theirs.close()


@pytest.fixture(scope="module")
def qos_server(twins):
    """One slot, one waiting; alpha keyed, gamma capped at 2 in flight."""
    engine = Engine(twins[1], EngineConfig(**dict(GEO, max_batch_slots=1)))
    srv = Server(engine, port=0, qos=QoSConfig(
        tenants={"alpha": TenantPolicy(weight=3.0),
                 "beta": TenantPolicy(weight=1.0),
                 "gamma": TenantPolicy(max_inflight=2)},
        api_keys={"sk-alpha": "alpha"},
        slo=SLOConfig(ttft_p99_ms=10_000.0, tpot_p99_ms=10_000.0)))
    yield srv
    srv.close()


# -- tiny HTTP client ------------------------------------------------------
def _post(port, body, headers=None, path="/v1/completions", timeout=120):
    payload = body if isinstance(body, bytes) else json.dumps(body).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=payload, headers={
            "Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, dict(resp.getheaders()), (
            json.loads(raw) if raw else None)
    finally:
        conn.close()


def _post_stream(port, body, headers=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions",
                     body=json.dumps(dict(body, stream=True)).encode(),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        assert resp.getheader("Content-Type").startswith("text/event-stream")
        events = []
        while True:
            line = resp.fp.readline()
            assert line, "stream ended before [DONE]"
            line = line.strip()
            if not line:
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                return events
            events.append(json.loads(payload))
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _wait(cond, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


# -- parity with the JAX server ---------------------------------------------
@pytest.mark.parametrize("body", [
    {"prompt": PROMPT, "max_tokens": N_NEW},
    {"prompt": [5, 6, 7, 8, 9], "max_new_tokens": 12},
    {"prompt": [4, 4], "max_tokens": 6, "stop_token_ids": [121]},
], ids=["max_tokens", "max_new_tokens", "stop"])
def test_blocking_and_sse_match_jax_server(servers, twins, body):
    mine, theirs = servers
    s1, _, b1 = _post(mine.port, body)
    s2, _, b2 = _post(theirs.port, body)
    assert s1 == s2 == 200
    for b in (b1, b2):
        b.pop("id")
    assert b1 == b2
    n = body.get("max_tokens", body.get("max_new_tokens"))
    ref = Engine(twins[1], EngineConfig(**GEO)).generate(
        [body["prompt"]], SamplingParams(
            max_new_tokens=n, stop_token_ids=body.get("stop_token_ids",
                                                      ())))[0]
    assert b1["choices"][0]["token_ids"] == ref.token_ids
    assert b1["choices"][0]["finish_reason"] == ref.finish_reason
    assert b1["usage"] == {
        "prompt_tokens": len(body["prompt"]),
        "completion_tokens": len(ref.token_ids),
        "total_tokens": len(body["prompt"]) + len(ref.token_ids)}
    e1, e2 = _post_stream(mine.port, body), _post_stream(theirs.port, body)
    for events in (e1, e2):
        streamed = [t for ev in events[:-1]
                    for t in ev["choices"][0]["token_ids"]]
        assert streamed == ref.token_ids
        final = events[-1]
        assert final["object"] == "text_completion.chunk"
        assert final["choices"][0]["token_ids"] == ref.token_ids
        assert final["choices"][0]["finish_reason"] == ref.finish_reason
        assert final["usage"] == b1["usage"]


@pytest.mark.parametrize("body", [
    b"{not json",
    [1, 2, 3],
    {},
    {"prompt": []},
    {"prompt": "hello"},
    {"prompt": [1, True, 3]},
    {"prompt": PROMPT, "max_tokens": "lots"},
    {"prompt": PROMPT, "temperature": 0},
    {"prompt": PROMPT, "top_p": 2.0},
    {"prompt": PROMPT, "stream": "yes"},
    {"prompt": PROMPT, "top_k": -1},
    {"prompt": PROMPT, "seed": "x"},
    {"prompt": list(range(1, 40))},
], ids=["json", "array", "no_prompt", "empty", "string", "bool_token",
        "max_tokens", "temperature", "top_p", "stream", "top_k", "seed",
        "too_long"])
def test_malformed_request_table_matches_jax(servers, body):
    mine, theirs = servers
    s1, _, b1 = _post(mine.port, body)
    s2, _, b2 = _post(theirs.port, body)
    assert s1 == s2 == 400
    assert b1 == b2
    assert b1["error"]["type"] == "invalid_request_error"


def test_unknown_endpoint_404_and_cohosted_observability(servers):
    mine, theirs = servers
    for srv in (mine, theirs):
        status, _, resp = _post(srv.port, {"prompt": PROMPT},
                                path="/v1/chat/completions")
        assert status == 404
        assert resp["error"]["type"] == "invalid_request_error"
    # one answered request of its own, so the latency series exists
    # whatever ran on this server before
    assert _post(mine.port, {"prompt": PROMPT, "max_tokens": 2})[0] == 200
    status, text = _get(mine.port, "/metrics")
    assert status == 200
    assert "paddle_tpu_serving_http_requests_total" in text
    assert 'paddle_tpu_serving_latency_seconds{engine="' in text
    status, body = _get(mine.port, "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"


def test_unknown_api_key_401(qos_server, twins):
    jeng = jax_serving.Engine(twins[0], jax_serving.EngineConfig(
        **GEO, analysis_check=None))
    jsrv = jax_serving.Server(jeng, port=0, qos=JaxQoSConfig(
        api_keys={"sk-alpha": "alpha"}))
    try:
        for srv in (qos_server, jsrv):
            status, _, resp = _post(
                srv.port, {"prompt": PROMPT, "max_tokens": 2},
                headers={"Authorization": "Bearer sk-wrong"})
            assert status == 401
            assert resp["error"]["type"] == "authentication_error"
    finally:
        jsrv.close()


def test_traceparent_honored_and_request_id_returned(twins, tmp_path):
    engine = Engine(twins[1], EngineConfig(**GEO,
                                           access_log=str(tmp_path)))
    srv = Server(engine, port=0)
    try:
        tid = "ab" * 16
        status, headers, body = _post(
            srv.port, {"prompt": PROMPT, "max_tokens": 2},
            headers={"traceparent": f"00-{tid}-{'cd' * 8}-01"})
        assert status == 200 and headers["x-request-id"] == body["id"]
        _, headers2, _ = _post(srv.port, {"prompt": PROMPT, "max_tokens": 2},
                               headers={"traceparent": "not-one"})
        minted = headers2["x-request-id"]
    finally:
        srv.close()
    from paddle_tpu_torch.serving.access_log import iter_records

    traces = {str(r["rid"]): r["trace"] for r in iter_records(str(tmp_path))}
    assert traces[body["id"]] == tid
    assert traces[minted] and traces[minted] != tid


def test_burst_of_concurrent_clients_is_answered(servers):
    """48 clients connecting at once (a burst like the serving cell's 32
    requests at t = 0): every connection is accepted and answered; the
    listen backlog is not socketserver's 5."""
    mine, _ = servers
    barrier = threading.Barrier(48)
    codes = []

    def one():
        barrier.wait()
        codes.append(_post(mine.port, {"prompt": PROMPT,
                                       "max_tokens": 2})[0])

    threads = [threading.Thread(target=one) for _ in range(48)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert codes == [200] * 48
    assert mine._httpd.request_queue_size >= 48


# -- QoS ----------------------------------------------------------------------
class _Pending:
    """A pending-queue entry as ``QoS.select`` reads it."""

    def __init__(self, request):
        self.request, self.done = request, False


@pytest.mark.parametrize("weights", [(3.0, 1.0), (1.0, 1.0), (2.0, 5.0)],
                         ids=["3to1", "equal", "2to5"])
def test_fair_share_order_matches_jax(weights):
    """Equal 12-deep backlogs of two tenants admitted at once, dispatched
    one at a time by ``select``: the port's order is JAX's, and a 3:1
    split interleaves ~3:1 instead of draining alpha first."""
    orders = []
    for qos_cls, cfg_cls, pol_cls, req_cls, sp_cls in (
            (QoS, QoSConfig, TenantPolicy, Request, SamplingParams),
            (JaxQoS, JaxQoSConfig, JaxTenantPolicy, jax_serving.Request,
             jax_serving.SamplingParams)):
        qos = qos_cls(cfg_cls(tenants={
            "alpha": pol_cls(weight=weights[0]),
            "beta": pol_cls(weight=weights[1])}))
        pending = []
        for i in range(24):
            req = req_cls([1, 2, 3], sp_cls(max_new_tokens=4 + i % 3),
                          request_id=i)
            req.tenant = "alpha" if i < 12 else "beta"
            qos.on_admit(req)
            pending.append(_Pending(req))
        order = []
        while pending:
            nxt = qos.select(pending)
            qos.on_dispatch(nxt.request)
            pending.remove(nxt)
            order.append(nxt.request.tenant)
        orders.append(order)
    assert orders[0] == orders[1]
    if weights == (3.0, 1.0):
        first16 = orders[0][:16]
        assert first16.count("alpha") == 12 and "beta" in orders[0][:6]


def test_quota_429_isolation_and_tenant_metrics(qos_server):
    results = {"alpha": [], "gamma": []}
    lock = threading.Lock()

    def worker(tenant, barrier=None):
        if barrier is not None:
            barrier.wait()
        out = _post(qos_server.port, {"prompt": list(PROMPT),
                                      "max_tokens": 24},
                    headers={"X-Tenant": tenant})
        with lock:
            results[tenant].append(out)

    alphas = [threading.Thread(target=worker, args=("alpha",))
              for _ in range(3)]
    for t in alphas:
        t.start()
    _wait(lambda: qos_server.qos.snapshot().get(
        "alpha", {}).get("received", 0) >= 3)
    barrier = threading.Barrier(3)
    gammas = [threading.Thread(target=worker, args=("gamma", barrier))
              for _ in range(3)]
    for t in gammas:
        t.start()
    for t in alphas + gammas:
        t.join(timeout=300)
        assert not t.is_alive()
    assert [s for s, _, _ in results["alpha"]] == [200] * 3
    assert sorted(s for s, _, _ in results["gamma"]) == [200, 200, 429]
    shed = next(r for r in results["gamma"] if r[0] == 429)
    assert shed[2]["error"]["type"] == "rate_limit_error"
    assert int(shed[1]["Retry-After"]) >= 1
    snap = qos_server.qos.snapshot()
    assert snap["gamma"]["shed_quota"] == 1
    assert snap["gamma"]["finished"] == 2
    _, text = _get(qos_server.port, "/metrics")
    for series in ("tenant_requests_total", "tenant_shed_quota_total"):
        assert re.search(
            rf'paddle_tpu_serving_{series}\{{[^}}]*tenant="gamma"', text)
    assert re.search(r'paddle_tpu_serving_latency\w*\{[^}]*tenant="alpha"',
                     text)
    assert re.search(r'paddle_tpu_serving_slo_burn_rate\{[^}]*tenant="alpha"',
                     text)


def test_token_rate_limit_sheds_with_retry_after(twins):
    engine = Engine(twins[1], EngineConfig(**GEO))
    srv = Server(engine, port=0, qos=QoSConfig(tenants={
        "t": TenantPolicy(tokens_per_s=1.0, burst_tokens=8)}))
    try:
        ok = _post(srv.port, {"prompt": PROMPT, "max_tokens": 8},
                   headers={"X-Tenant": "t"})
        shed = _post(srv.port, {"prompt": PROMPT, "max_tokens": 8},
                     headers={"X-Tenant": "t"})
    finally:
        srv.close()
    assert ok[0] == 200
    assert shed[0] == 429 and int(shed[1]["Retry-After"]) >= 1
    assert srv.qos.snapshot()["t"]["shed_rate"] == 1


# -- failure paths --------------------------------------------------------------
def _raw_stream_then_reset(port, body, chunks=1):
    payload = json.dumps(dict(body, stream=True)).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        sock.sendall(
            b"POST /v1/completions HTTP/1.1\r\nHost: localhost\r\n"
            b"Content-Type: application/json\r\nContent-Length: "
            + str(len(payload)).encode() + b"\r\n\r\n" + payload)
        buf = b""
        while buf.count(b"\ndata: ") < chunks:
            chunk = sock.recv(4096)
            assert chunk, "closed before the first SSE chunk"
            buf += chunk
    finally:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()


def test_mid_stream_disconnect_aborts_no_slot_leak(twins):
    engine = Engine(twins[1], EngineConfig(**GEO))
    srv = Server(engine, port=0)
    try:
        _raw_stream_then_reset(srv.port, {"prompt": [5, 6, 7],
                                          "max_tokens": 24})
        _wait(lambda: not srv._streams and not engine.has_unfinished())
        assert srv.metrics.disconnects >= 1
        assert engine.block_manager.num_used == 0
        # the server keeps serving
        assert _post(srv.port, {"prompt": PROMPT, "max_tokens": 2})[0] == 200
    finally:
        srv.close()


def test_accept_and_stream_faults_degrade_one_request(twins):
    engine = Engine(twins[1], EngineConfig(**GEO))
    srv = Server(engine, port=0)
    try:
        with faults.inject({"http.accept": FaultSpec(OSError("boom"),
                                                     at=1)}):
            with pytest.warns(UserWarning, match="http.accept"):
                status, _, body = _post(srv.port, {"prompt": PROMPT})
        assert status == 500 and body["error"]["type"] == "internal_error"
        with faults.inject({"http.stream": FaultSpec(RuntimeError("wire"),
                                                     at=1)}):
            with pytest.warns(UserWarning, match="stream write failed"):
                conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                  timeout=60)
                conn.request("POST", "/v1/completions", body=json.dumps({
                    "prompt": PROMPT, "max_tokens": 16,
                    "stream": True}).encode())
                resp = conn.getresponse()
                resp.read()      # the first chunk fails: nothing follows
                conn.close()
                _wait(lambda: not srv._streams
                      and not engine.has_unfinished())
        assert srv.metrics.accept_faults == 1
        assert srv.metrics.stream_faults == 1
        assert engine.block_manager.num_used == 0
        assert _post(srv.port, {"prompt": PROMPT, "max_tokens": 2})[0] == 200
    finally:
        srv.close()


def test_drain_finishes_inflight_then_503(twins):
    engine = Engine(twins[1], EngineConfig(**GEO))
    srv = Server(engine, port=0)
    try:
        done = {}

        def go():
            done["events"] = _post_stream(srv.port, {"prompt": [2, 4, 6],
                                                     "max_tokens": N_NEW})

        t = threading.Thread(target=go)
        t.start()
        _wait(lambda: srv._streams or not t.is_alive())
        assert srv.drain(timeout=120)
        status, _, body = _post(srv.port, {"prompt": PROMPT,
                                           "max_tokens": 2})
        assert status == 503
        assert body["error"]["type"] == "server_draining"
        t.join(timeout=60)
        assert not t.is_alive()
        final = done["events"][-1]
        assert len(final["choices"][0]["token_ids"]) == N_NEW
        assert final["choices"][0]["finish_reason"] == "length"
        assert json.loads(_get(srv.port, "/healthz")[1])["providers"][
            f"serving.server.{srv.server_id}"]["status"] == "draining"
    finally:
        srv.close()


def test_device_fault_fails_inflight_and_stops(twins):
    """A device fault in a step (a CUDA error is sticky) is not retried:
    the in-flight requests finish with an error, new ones answer 503
    ``backend_failed`` and ``/healthz`` says failed."""
    engine = Engine(twins[1], EngineConfig(**GEO))
    srv = Server(engine, port=0)
    real_step = engine.step
    calls = []

    def faulty_step():
        calls.append(1)
        if len(calls) == 3:
            raise torch.AcceleratorError("CUDA error: an illegal memory "
                                         "access was encountered")
        return real_step()

    engine.step = faulty_step
    try:
        with pytest.warns(UserWarning, match="device fault"):
            status, _, body = _post(srv.port, {"prompt": PROMPT,
                                               "max_tokens": 16})
        assert status == 500 and "illegal memory access" in \
            body["error"]["message"]
        assert len(calls) == 3       # stopped: no retry after the fault
        status, _, body = _post(srv.port, {"prompt": PROMPT})
        assert status == 503 and body["error"]["type"] == "backend_failed"
        code, text = _get(srv.port, "/healthz")
        assert code == 503
        assert json.loads(text)["providers"][
            f"serving.server.{srv.server_id}"]["status"] == "failed"
        assert srv.metrics.step_errors == srv.metrics.device_faults == 1
    finally:
        srv.close()


def test_transient_step_error_is_retried(twins):
    engine = Engine(twins[1], EngineConfig(**GEO))
    srv = Server(engine, port=0)
    real_step, calls = engine.step, []

    def flaky_step():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("transient")
        return real_step()

    engine.step = flaky_step
    try:
        with pytest.warns(UserWarning, match="backend step failed"):
            status, _, body = _post(srv.port, {"prompt": PROMPT,
                                               "max_tokens": 4})
        assert status == 200 and len(body["choices"][0]["token_ids"]) == 4
        assert srv.metrics.step_errors == 1
        assert srv.metrics.device_faults == 0
    finally:
        srv.close()


# -- CLI --------------------------------------------------------------------------
@pytest.mark.parametrize("argv,needle", [
    (["serve", "--model", "nope", "--device", "cpu"], "unknown model"),
    (["serve", "--model", "tiny", "--port", "99999"], "--port"),
    (["serve", "--model", "tiny", "--api-key", "broken"], "--api-key"),
    (["serve", "--model", "tiny", "--tp-degree", "0"], "--tp-degree"),
    (["serve", "--model", "tiny", "--replicas", "-1"], "--replicas"),
], ids=["model", "port", "api_key", "tp_degree", "replicas"])
def test_cli_named_config_errors_as_jax(capsys, argv, needle):
    from paddle_tpu.serving.__main__ import main as jax_main
    from paddle_tpu_torch.serving.__main__ import main

    assert main(argv) == 2
    err = capsys.readouterr().err
    assert "error: ConfigError" in err and needle in err
    jax_argv = [a for a in argv if a not in ("--device", "cpu")]
    assert jax_main(jax_argv) == 2
    jerr = capsys.readouterr().err
    assert "error: ConfigError" in jerr and needle in jerr


@pytest.mark.parametrize("argv,module", [
    (["--tp-degree", "2"], "tensor parallelism"),
    (["--compile-cache", "/nonexistent"], "compile cache"),
], ids=["tp_degree", "compile_cache"])
def test_cli_refuses_unported_flags(capsys, argv, module):
    from paddle_tpu_torch.serving.__main__ import main

    assert main(["serve", "--model", "tiny", "--device", "cpu"]
                + argv) == 2
    err = capsys.readouterr().err
    assert "error: ConfigError" in err and module in err
    assert "does not port yet" in err


def test_cli_replicas_builds_a_fleet(capsys, monkeypatch, tmp_path):
    """``--replicas 2`` serves through a 2-replica Fleet, as JAX's CLI
    does, with ``--max-pending`` and ``--journal-dir`` on the fleet (the
    server is replaced by a stub that returns at once)."""
    from paddle_tpu_torch.serving import server as server_mod
    from paddle_tpu_torch.serving.__main__ import main

    seen = {}

    class _Stub:
        url, _closed = "http://stub", True

    def fake_serve(backend, **kw):
        seen["backend"], seen["kw"] = backend, kw
        return _Stub()

    monkeypatch.setattr(server_mod, "serve", fake_serve)
    jdir = str(tmp_path / "wal")
    assert main(["serve", "--model", "tiny", "--device", "cpu",
                 "--replicas", "2", "--max-pending", "3",
                 "--journal-dir", jdir, "--max-model-len", "64"]) == 0
    fleet = seen["backend"]
    assert isinstance(fleet, Fleet) and fleet.size() == 2
    assert [s.status for s in fleet.replicas] == ["healthy", "healthy"]
    assert fleet.config.max_pending == 3
    assert fleet.config.journal_dir == jdir and fleet.journal is not None
    # the journal is the fleet's, not each replica's
    assert all(s.engine.journal is None for s in fleet.replicas)
    assert "fleet of 2 on cpu" in capsys.readouterr().out
    assert main(["serve", "--model", "tiny", "--device", "cpu",
                 "--replicas", "1", "--max-pending", "0"]) == 2
    assert "max_pending" in capsys.readouterr().err


def _fleet_server(twins, **srv_kw):
    fleet = Fleet(twins[1], EngineConfig(**GEO),
                  FleetConfig(num_replicas=2))
    return fleet, Server(fleet, port=0, **srv_kw)


def test_http_over_a_two_replica_fleet(twins):
    fleet, srv = _fleet_server(twins, qos=QoSConfig(
        api_keys={"key-a": "a", "key-b": "b"},
        tenants={"a": TenantPolicy(weight=2.0),
                 "b": TenantPolicy(weight=1.0)}))
    prompts = [[i + 1, i + 2, i + 3] for i in range(8)]
    results = [None] * len(prompts)
    try:
        assert fleet.qos is srv.qos

        def go(i):
            tenant = "a" if i % 2 == 0 else "b"
            body = {"prompt": prompts[i], "max_tokens": N_NEW}
            headers = {"Authorization": f"Bearer key-{tenant}"}
            if i % 4 < 2:
                status, _, resp = _post(srv.port, body, headers)
                results[i] = (tenant, status, resp["tenant"],
                              resp["choices"][0]["token_ids"])
            else:
                events = _post_stream(srv.port, body, headers)
                results[i] = (tenant, 200, events[-1]["tenant"],
                              events[-1]["choices"][0]["token_ids"])

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        ref = Engine(twins[1], EngineConfig(**GEO)).generate(
            prompts, SamplingParams(max_new_tokens=N_NEW))
        for (tenant, status, got_tenant, tokens), want in zip(results, ref):
            assert status == 200 and got_tenant == tenant
            assert tokens == want.token_ids
        m = fleet.metrics
        assert m.requests_received == m.requests_finished == len(prompts)
        snap = srv.qos.snapshot()
        assert snap["a"]["finished"] == snap["b"]["finished"] == 4
        assert snap["a"]["inflight"] == snap["b"]["inflight"] == 0
        assert sum(s.engine.metrics.requests_finished
                   for s in fleet.replicas) == len(prompts)
        code, text = _get(srv.port, "/healthz")
        assert code == 200
        probe = json.loads(text)["providers"][
            f"serving.fleet.{fleet.fleet_id}"]
        assert probe["replicas"] == {"r0": "healthy", "r1": "healthy"}
        assert probe["routable"] == 2
        assert "paddle_tpu_fleet_requests_finished_total" in _get(
            srv.port, "/metrics")[1]
    finally:
        srv.close()


def test_device_fault_in_a_fleet_stops_the_server(twins):
    """A fleet re-raises a replica's device fault instead of failing the
    replica over; the server's driver then fails the in-flight requests
    and stops, as over one engine."""
    fleet, srv = _fleet_server(twins)

    def device_fault(_ctx):
        raise torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered")

    spec = FaultSpec(action=device_fault, at=3,
                     when=lambda c: c.get("phase") == "step")
    try:
        with faults.inject({"serving.replica": spec}):
            with pytest.warns(UserWarning, match="device fault"):
                status, _, body = _post(srv.port, {"prompt": PROMPT,
                                                   "max_tokens": 16})
        assert status == 500 and "illegal memory access" in \
            body["error"]["message"]
        assert fleet.metrics.failovers == 0
        assert all(s.restarts == 0 for s in fleet.replicas)
        status, _, body = _post(srv.port, {"prompt": PROMPT})
        assert status == 503 and body["error"]["type"] == "backend_failed"
        assert srv.metrics.device_faults == 1
    finally:
        srv.close()


def test_cli_usage_moe_refusal_and_default_device(capsys):
    from paddle_tpu.serving.__main__ import main as jax_main
    from paddle_tpu_torch.serving.__main__ import main

    assert main([]) == 2
    assert jax_main([]) == 2
    # the adapter's MoE refusal, as in JAX
    with pytest.raises(NotImplementedError, match="MoE"):
        main(["serve", "--model", "tiny-moe", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="MoE"):
        jax_main(["serve", "--model", "tiny-moe"])
    if torch.cuda.is_available():
        return
    # without --device the engine goes to the card: a named error here
    capsys.readouterr()
    assert main(["serve", "--model", "tiny", "--port", "0"]) == 2
    err = capsys.readouterr().err
    assert "error: ConfigError" in err and "no CUDA device" in err
    assert "--device cpu" in err


def test_sigterm_drains_a_cli_server_process(tmp_path):
    """``python -m paddle_tpu_torch.serving serve --device cpu``: it
    answers blocking and SSE completions, /metrics and /healthz, and
    SIGTERM mid-stream lets the stream finish, then exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving", "serve",
         "--model", "tiny", "--device", "cpu", "--port", "0",
         "--max-batch-slots", "2", "--max-model-len", "64",
         "--journal-dir", str(tmp_path / "wal")],
        cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://127\.0\.0\.1:(\d+)", line)
        assert m, f"no listening line: {line!r}"
        assert "engine on cpu" in line
        port = int(m.group(1))
        status, _, body = _post(port, {"prompt": [1, 2, 3],
                                       "max_tokens": 4})
        assert status == 200 and len(body["choices"][0]["token_ids"]) == 4
        assert _get(port, "/healthz")[0] == 200
        assert "paddle_tpu_serving_http_requests_total" in _get(
            port, "/metrics")[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions", body=json.dumps({
            "prompt": [1, 2, 3], "max_tokens": 40,
            "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.fp.readline().startswith(b"data: ")
        proc.send_signal(signal.SIGTERM)
        saw_done = False
        while True:
            ln = resp.fp.readline()
            if not ln:
                break
            if ln.strip() == b"data: [DONE]":
                saw_done = True
        conn.close()
        assert saw_done, "drain cut the in-flight stream short"
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
