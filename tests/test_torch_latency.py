"""Latency digests, SLO burn, the access log and request timelines of the
port (``paddle_tpu_torch.observability``, ``serving.access_log``) on the
CPU, against the JAX package's:

  * ``LatencyDigest`` quantiles, snapshots and merges equal the JAX
    digest's for the same numpy-seeded samples; the summary and histogram
    families render the same samples;
  * ``SLOTracker`` burn rates, sustained burn and window expiry equal
    JAX's on the same records; ``SLOConfig`` validation;
  * access-log rotation, the torn-tail reader, and the ``obs.accesslog``
    fault degrading to a counted warn-once;
  * engine timelines: the port engine and the JAX engine on the same
    workload and weights (chunked prefill + prefix cache + speculation,
    and a starved pool that preempts) give the same tokens and the same
    per-request timeline counters; each access-log line carries them; the
    latency series answer on ``/metrics``; sustained burn flips
    ``health()`` and ``/healthz``; a journal replay anchors a recovered
    request's arrival at its journaled admission.
"""
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import latency as jax_latency
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.observability.latency import (
    LatencyDigest,
    SLOConfig,
    SLOTracker,
    histogram_family,
    summary_family,
)
from paddle_tpu_torch.resilience import FaultSpec, faults
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving.access_log import (
    AccessLog,
    iter_records,
    resolve_access_log,
)

QS = (0.0, 0.01, 0.5, 0.9, 0.99, 1.0)


def _samples(kind, seed, n):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(-3.0, 1.0, n)
    return np.concatenate([rng.exponential(0.05, n - 4),
                           [0.0, 1e-7, 2.5, 3600.0]])


# -- digests -------------------------------------------------------------
@pytest.mark.parametrize("kind", ["lognormal", "exponential_with_edges"])
def test_digest_quantiles_equal_jax(kind):
    vals = _samples(kind, 0, 5000)
    mine, theirs = LatencyDigest(), jax_latency.LatencyDigest()
    for v in vals:
        mine.record(v)
        theirs.record(v)
    assert mine.snapshot() == theirs.snapshot()
    for q in QS:
        assert mine.quantile(q) == theirs.quantile(q)
    assert mine.mean == theirs.mean
    for q in (0.5, 0.9, 0.99):
        true = float(np.quantile(vals, q))
        assert abs(mine.quantile(q) - true) / max(true, 1e-6) < 0.045


@pytest.mark.parametrize("growth", [1.09, 1.5])
def test_digest_merge_equals_pooled_and_jax(growth):
    vals = _samples("exponential_with_edges", 1, 4000)
    pooled = LatencyDigest(growth=growth)
    shards = [LatencyDigest(growth=growth) for _ in range(4)]
    jshards = [jax_latency.LatencyDigest(growth=growth) for _ in range(4)]
    for i, v in enumerate(vals):
        pooled.record(v)
        shards[i % 4].record(v)
        jshards[i % 4].record(v)
    merged = LatencyDigest(growth=growth)
    jmerged = jax_latency.LatencyDigest(growth=growth)
    for s, js in zip(shards, jshards):
        merged.merge(s)
        jmerged.merge(js)
    pc, pn, ps, pm = pooled.snapshot()
    mc, mn, ms, mm = merged.snapshot()
    assert (pc, pn, pm) == (mc, mn, mm)
    assert abs(ps - ms) < 1e-9 * abs(ps)
    assert merged.snapshot() == jmerged.snapshot()
    for q in QS:
        assert merged.quantile(q) == pooled.quantile(q) == \
            jmerged.quantile(q)
    assert merged.copy().snapshot() == merged.snapshot()


def test_digest_validation_and_empty():
    with pytest.raises(ValueError, match="bucket schemes"):
        LatencyDigest(growth=1.09).merge(LatencyDigest(growth=1.5))
    with pytest.raises(ValueError):
        LatencyDigest(growth=1.0)
    with pytest.raises(ValueError):
        LatencyDigest(min_value=0.0)
    d = LatencyDigest()
    assert d.count == 0 and d.quantile(0.5) is None and d.mean is None
    d.record(0.0)
    assert d.quantile(0.5) == d.min_value
    with pytest.raises(ValueError):
        d.quantile(1.5)


def test_families_render_as_jax():
    vals = _samples("lognormal", 2, 300)
    mine = {"ttft": LatencyDigest(), "tpot": LatencyDigest()}
    theirs = {"ttft": jax_latency.LatencyDigest(),
              "tpot": jax_latency.LatencyDigest()}
    for v in vals:
        mine["ttft"].record(v)
        theirs["ttft"].record(v)
    labels = {"engine": "9"}
    for fn, jfn in ((summary_family, jax_latency.summary_family),
                    (histogram_family, jax_latency.histogram_family)):
        a, b = fn("x_seconds", mine, labels), jfn("x_seconds", theirs,
                                                  labels)
        assert (a.kind, a.samples) == (b.kind, b.samples)
        # the empty tpot digest exports nothing
        assert all(s[1]["phase"] == "ttft" for s in a.samples)


# -- SLO -----------------------------------------------------------------
SLO_CFG = dict(ttft_p99_ms=100.0, tpot_p99_ms=20.0, window_s=60.0,
               min_samples=5)


@pytest.mark.parametrize("case", ["burn", "min_samples", "expiry",
                                  "random"])
def test_slo_tracker_equals_jax(case):
    mine = SLOTracker(SLOConfig(**SLO_CFG))
    theirs = jax_latency.SLOTracker(jax_latency.SLOConfig(**SLO_CFG))
    rng = np.random.default_rng(5)
    if case == "burn":       # 10 requests, 1 ttft violation: 10x burn
        recs = [(0.5 if i == 0 else 0.01, 0.005, 100.0 + i)
                for i in range(10)]
        at = [110.0]
    elif case == "min_samples":
        recs = [(9.0, None, 100.0 + i) for i in range(3)]
        at = [103.0]
    elif case == "expiry":
        recs = [(9.0, None, 100.0 + i) for i in range(10)]
        at = [105.0, 500.0]
    else:
        recs = [(float(t), float(p), float(n)) for t, p, n in zip(
            rng.exponential(0.05, 200), rng.exponential(0.01, 200),
            np.sort(rng.uniform(0.0, 120.0, 200)))]
        at = [30.0, 60.0, 90.0, 120.0, 200.0]
    for ttft, tpot, now in recs:
        mine.record(ttft_s=ttft, tpot_s=tpot, now=now)
        theirs.record(ttft_s=ttft, tpot_s=tpot, now=now)
    seen = {}
    for now in at:   # in time order: a read drops expired sub-windows
        assert mine.window_counts(now) == theirs.window_counts(now)
        seen[now] = (mine.burn_rates(now), mine.burning(now))
        assert seen[now] == (theirs.burn_rates(now), theirs.burning(now))
    if case == "burn":
        assert seen[110.0][0]["ttft"] == pytest.approx(10.0)
        assert seen[110.0][1]
    if case == "min_samples":
        assert seen[103.0][0]["ttft"] == pytest.approx(100.0)
        assert not seen[103.0][1]
    if case == "expiry":
        assert seen[105.0][1] and not seen[500.0][1]
        assert seen[500.0][0]["ttft"] is None


@pytest.mark.parametrize("kw", [
    {}, {"ttft_p99_ms": -1}, {"ttft_p99_ms": 100, "window_s": 0},
    {"ttft_p99_ms": 100, "objective": 1.0},
    {"ttft_p99_ms": 100, "burn_threshold": 0},
    {"ttft_p99_ms": 100, "min_samples": 0},
], ids=["no_target", "negative", "window", "objective", "threshold",
        "min_samples"])
def test_slo_config_validation_as_jax(kw):
    with pytest.raises(ValueError) as mine:
        SLOConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_latency.SLOConfig(**kw)
    assert str(mine.value) == str(theirs.value)


def test_slo_tracker_and_engine_need_an_slo_config():
    with pytest.raises(TypeError):
        SLOTracker({"ttft_p99_ms": 100})
    with pytest.raises(TypeError, match="SLOConfig"):
        EngineConfig(slo={"ttft_p99_ms": 100})


# -- access log ----------------------------------------------------------
def _rec(i):
    return {"rid": i, "finish_reason": "length", "ttft_s": 0.01}


def test_access_log_rotation_and_keep_files(tmp_path):
    al = AccessLog(tmp_path, rotate_bytes=200, keep_files=3)
    for i in range(50):
        al.log(_rec(i))
    assert 1 < len(al.files()) <= 3
    assert al.rotations > 0 and al.write_errors == 0
    recs = list(iter_records(tmp_path))
    assert recs[-1]["rid"] == 49     # the survivors hold the tail
    assert [r["rid"] for r in recs] == list(range(50 - len(recs), 50))
    al.close()


def test_access_log_reader_skips_torn_tail(tmp_path):
    al = AccessLog(tmp_path)
    for i in range(5):
        al.log(_rec(i))
    al.close()
    path = os.path.join(tmp_path, al.files()[-1])
    with open(path, "ab") as f:
        f.write(b'{"rid": 99, "tr')
    assert [r["rid"] for r in iter_records(tmp_path)] == [0, 1, 2, 3, 4]


def test_access_log_fault_degrades_never_raises(tmp_path):
    al = AccessLog(tmp_path)
    with faults.inject({"obs.accesslog": FaultSpec(OSError("gone"),
                                                   every=1)}) as inj:
        with pytest.warns(UserWarning, match="lossy access log"):
            al.log(_rec(0))
        al.log(_rec(1))
    assert inj.fired["obs.accesslog"] == 2
    assert al.write_errors == 2 and al.records_written == 0
    al.log(_rec(2))
    assert al.records_written == 1
    assert any(k.startswith("paddle_tpu_serving_accesslog_errors_total")
               and v == 2 for k, v in obs.get_registry().snapshot().items())
    al.close()


def test_resolve_access_log_shares_per_directory(tmp_path):
    a = resolve_access_log(str(tmp_path))
    assert resolve_access_log(str(tmp_path)) is a
    assert resolve_access_log(a) is a
    with pytest.raises(ValueError):
        AccessLog(tmp_path, rotate_bytes=0)
    with pytest.raises(ValueError):
        AccessLog(tmp_path, keep_files=0)


# -- engine timelines against the JAX engine ------------------------------
@pytest.fixture(scope="module")
def twins():
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny())
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return jax_model, port


CONFIGS = {
    # chunked prefill + prefix cache + speculation at once (the JAX
    # package's observability acceptance configuration)
    "chunk_prefix_spec": dict(
        max_batch_slots=4, max_model_len=32, page_size=4, num_blocks=32,
        prefill_buckets=[16, 32], enable_prefix_cache=True,
        prefill_chunk_tokens=8, max_prefill_chunks_per_step=2,
        speculate_tokens=2),
    # a pool too small for every slot: recompute preemptions
    "preempting": dict(max_batch_slots=4, max_model_len=32, page_size=4,
                       num_blocks=10, prefill_buckets=[16, 32]),
}
COUNTERS = ("prefill_chunks", "prefill_tokens", "prefix_hit_tokens",
            "decode_tokens", "verify_steps", "spec_accepted", "preemptions",
            "resumes", "finish_reason", "recovered")


def _workload():
    """Greedy, heterogeneous lengths, a shared 24-token prefix on half of
    them (prefix hits, several chunks), prompt + new <= 32."""
    rng = np.random.default_rng(7)
    shared = list(range(1, 9)) * 3
    prompts, max_new = [], []
    for i in range(16):
        if i % 2:
            prompts.append(shared + rng.integers(1, 128, 2).tolist())
            max_new.append(4)
        else:
            n = int(rng.choice([4, 7, 10, 13]))
            prompts.append(rng.integers(1, 128, n).tolist())
            max_new.append(16 - n)
    return prompts, max_new


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_timelines_and_access_log_match_jax_engine(twins, config,
                                                   tmp_path):
    jax_model, port = twins
    prompts, max_new = _workload()
    cfg = CONFIGS[config]
    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(
        **cfg, analysis_check=None))
    jouts = jeng.generate(prompts, [jax_serving.SamplingParams(
        max_new_tokens=k) for k in max_new])
    eng = Engine(port, EngineConfig(**cfg, access_log=str(tmp_path)))
    outs = eng.generate(prompts, [SamplingParams(max_new_tokens=k)
                                  for k in max_new])
    assert [o.token_ids for o in outs] == [o.token_ids for o in jouts]
    for o, j in zip(outs, jouts):
        assert {k: o.metrics[k] for k in COUNTERS} == \
            {k: j.metrics[k] for k in COUNTERS}
        mt = o.metrics
        assert 0 <= mt["queue_wait_s"] <= mt["ttft_s"] <= mt["e2e_s"]
        assert mt["hops"] == [eng.engine_id]
    m, jm = eng.metrics, jeng.metrics
    assert (m.preemptions, m.prefill_chunks, m.prefix_hit_tokens,
            m.verify_steps, m.spec_accepted) == (
        jm.preemptions, jm.prefill_chunks, jm.prefix_hit_tokens,
        jm.verify_steps, jm.spec_accepted)
    if config == "preempting":
        assert m.preemptions > 0
    else:
        assert m.prefill_chunks > 0 and m.prefix_hit_tokens > 0
        assert m.verify_steps > 0
    # the digests: one ttft, queue and e2e sample per request
    for phase in ("queue", "ttft", "e2e"):
        assert m.latency[phase].count == len(prompts)
    assert m.mean_ttft == pytest.approx(
        m.latency["ttft"].sum / m.latency["ttft"].count)
    # one access-log line per request, with its timeline counters
    lines = {r["rid"]: r for r in iter_records(str(tmp_path))}
    assert len(lines) == len(prompts)
    for o in outs:
        line = lines[o.request_id]
        assert line["engine"] == eng.engine_id
        assert line["output_tokens"] == len(o.token_ids)
        assert line["prompt_tokens"] == len(o.prompt_token_ids)
        assert {k: line[k] for k in COUNTERS} == \
            {k: o.metrics[k] for k in COUNTERS}


def test_latency_series_scrape_and_flight_ring(twins, tmp_path):
    _, port = twins
    eng = Engine(port, EngineConfig(max_batch_slots=4, max_model_len=32,
                                    page_size=4))
    out = eng.generate([[5, 6, 7], [1, 2]],
                       SamplingParams(max_new_tokens=3))[0]
    with obs.start_scrape_server() as srv:
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=10).read().decode()
    eid = eng.engine_id
    for phase in ("ttft", "tpot", "e2e", "queue"):
        for q in ("0.5", "0.9", "0.99"):
            needle = (f'paddle_tpu_serving_latency_seconds{{engine="{eid}",'
                      f'phase="{phase}",quantile="{q}"}}')
            assert needle in text, needle
    assert (f'paddle_tpu_serving_latency_hist_seconds_bucket{{'
            f'engine="{eid}",le="+Inf",phase="ttft"}} 2') in text
    assert f'paddle_tpu_serving_requests_finished_total{{engine="{eid}"}}' \
        in text
    mine = [t for t in obs.flight.get_flight_recorder().timelines()
            if t["rid"] == out.request_id and t.get("engine") == eid]
    assert mine and mine[0]["finish_reason"] == out.finish_reason
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = str(tmp_path)
    try:
        path = obs.dump("test-timelines")
    finally:
        del os.environ["PADDLE_TPU_FLIGHT_DIR"]
    with open(path) as f:
        payload = json.load(f)
    assert any(t.get("rid") == out.request_id
               for t in payload["request_timelines"])


def test_sustained_burn_degrades_health_and_healthz(twins):
    _, port = twins
    eng = Engine(port, EngineConfig(
        max_batch_slots=4, max_model_len=32, page_size=4,
        slo=SLOConfig(ttft_p99_ms=1e-6, window_s=60.0, min_samples=2)))
    assert eng.health()["status"] == "ok"
    assert eng.health()["slo_burn_rates"] == {"ttft": None}
    eng.generate([[1, 2], [3, 4], [5, 6]], SamplingParams(max_new_tokens=2))
    h = eng.health()
    assert "slo_burn" in h["flags"] and h["status"] == "degraded"
    assert h["slo_burn_rates"]["ttft"] == pytest.approx(100.0)
    with obs.start_scrape_server() as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=10).read().decode()
    assert e.value.code == 503
    assert (f'paddle_tpu_serving_slo_burning{{engine="{eng.engine_id}"}} 1'
            in text)
    del eng   # the health provider goes with the engine


def test_recovered_request_anchors_journaled_arrival(tmp_path):
    from paddle_tpu_torch.serving.journal import Journal, restore_entries
    from paddle_tpu_torch.serving.request import Request

    j = Journal(str(tmp_path))
    req = Request([1, 2, 3], SamplingParams(max_new_tokens=8, ttl_s=60))
    j.admit(req)
    j._buffer[-1]["ts"] = time.time() - 5.0   # admitted 5 s before a crash
    j.flush(force=True)
    j.close()
    j2 = Journal(str(tmp_path))
    live, expired = restore_entries(
        j2, j2.replay(), lambda e, p: Request(e.prompt, p, request_id=e.rid))
    assert expired == 0 and len(live) == 1
    r = live[0]
    assert 4.0 < time.perf_counter() - r.arrival_time < 7.0
    assert r.timeline.recovered and r.timeline.arrival == r.arrival_time
    assert 50.0 < r.deadline - time.perf_counter() < 56.0
