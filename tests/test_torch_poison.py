"""Poison isolation in the port's engine (``Engine._poison``/``_isolate``)
against the JAX engine's, on the CPU: the same fault schedules at the
``serving.step`` site on twin engines (tiny Llama, MHA and GQA, the same
weights; the JAX engines with the analysis gate off). These are the JAX
cases of ``tests/test_serving.py`` (``TestGracefulDegradation``: poison
prefill, unattributed decode bisection, attributed decode), and also a
poisoned verify launch (speculative decoding), a poisoned chunk of a
chunked prefill, and a copy-on-write that raises. Compared: finish
reasons, the survivors' greedy tokens, ``requests_errored`` and
``last_error``, the sizes of the launches the fault's ``when`` saw, and
``health()``'s status, flags and ``watchdog``. Port only: a
``torch.AcceleratorError`` (a CUDA error, sticky for the process) is
never contained: it re-raises after one launch attempt, from prefill,
decode and verify alike, and the step's postmortem names it.
"""
import collections
import json

import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.resilience import FaultSpec as JaxFaultSpec
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.serving import speculation as jax_speculation
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.resilience import FaultSpec, faults
from paddle_tpu_torch.serving import speculation

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11]]
SMALL = dict(max_batch_slots=4, max_model_len=32, page_size=4, seed=3)
CHUNKED = dict(SMALL, prefill_chunk_tokens=2, enable_prefix_cache=True)
SPEC = dict(SMALL, num_blocks=48, prefill_buckets=[16, 32],
            speculate_tokens=3)
SPEC_PROMPTS = [[5, 6] * 4, [7, 8, 9] * 3, [3] * 6, [10, 11] * 3]

Side = collections.namedtuple("Side", "name serving faults FaultSpec engines")


@pytest.fixture(scope="module", params=["mha", "gqa"])
def sides(request):
    kv = 2 if request.param == "gqa" else None
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(num_key_value_heads=kv))
    port = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv),
                            device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    out = []
    for name, s, f, fs, model, extra in (
            ("jax", jax_serving, jax_faults, JaxFaultSpec, jax_model,
             dict(analysis_check=None)),
            ("port", serving, faults, FaultSpec, port, {})):
        engines = {key: s.Engine(model, s.EngineConfig(**cfg, **extra))
                   for key, cfg in (("small", SMALL), ("chunked", CHUNKED),
                                    ("spec", SPEC))}
        out.append(Side(name, s, f, fs, engines))
    return out


def _drain(engine):
    done, guard = {}, 0
    while engine.has_unfinished():
        for out in engine.step():
            done[out.request_id] = out
        guard += 1
        assert guard < 300, "engine failed to drain"
    return done


def _run(side, engine, prompts, spec=None, max_new=4):
    """Submit ``prompts`` and drain under ``spec`` (a {site: FaultSpec}
    schedule); returns per prompt (finish reason, tokens, error)."""
    params = side.serving.SamplingParams(max_new_tokens=max_new)
    reqs = [engine.add_request(p, params) for p in prompts]
    if spec is None:
        out = _drain(engine)
    else:
        with side.faults.inject(spec):
            out = _drain(engine)
    return reqs, [(out[r.request_id].finish_reason,
                   out[r.request_id].token_ids, out[r.request_id].error)
                  for r in reqs]


def _health(engine):
    h = engine.health()
    return {k: h[k] for k in ("status", "flags", "watchdog",
                              "requests_errored")}


@pytest.fixture
def drafting(monkeypatch):
    """Every greedy slot drafts its last ``budget`` tokens (both
    packages' engines call ``speculation.propose`` through the module),
    so every decode step of the speculative engines is a verify launch."""
    def propose(history, budget, max_ngram=3):
        return list(history[-budget:]) if budget > 0 else []

    for mod in (speculation, jax_speculation):
        monkeypatch.setattr(mod, "propose", propose)


def _both(sides, scenario):
    """``scenario(side)`` on the JAX engine and the port's: the same
    result, returned."""
    got = {side.name: scenario(side) for side in sides}
    assert got["port"] == got["jax"]
    return got["port"]


def _last_error_text(engine, rid):
    """``last_error`` without the request id (the engines number their
    requests apart)."""
    m = engine.metrics
    prefix = f"request {rid}: "
    assert m.last_error.startswith(prefix)
    return m.last_error[len(prefix):]


def test_health_starts_ok_with_watchdog_off(sides):
    h = _both(sides, lambda side: _health(side.engines["small"]))
    assert h["watchdog"] == {"enabled": False, "fired": None}


def test_poison_prefill_isolated(sides):
    def scenario(side):
        eng = side.engines["small"]
        before = eng.metrics.requests_errored
        _, ref = _run(side, eng, PROMPTS)
        params = side.serving.SamplingParams(max_new_tokens=4)
        reqs = [eng.add_request(p, params) for p in PROMPTS]
        rid = reqs[2].request_id
        spec = side.FaultSpec(
            RuntimeError("bad weights"),
            when=lambda c: (c.get("phase") == "prefill"
                            and c.get("request_id") == rid))
        with side.faults.inject({"serving.step": spec}):
            out = _drain(eng)
        got = [(out[r.request_id].finish_reason, out[r.request_id].token_ids)
               for r in reqs]
        assert got[2] == ("error", [])
        assert "bad weights" in out[rid].error
        for i in (0, 1, 3):
            assert got[i] == ref[i][:2]
        assert eng.block_manager.num_used == 0
        assert eng.metrics.requests_errored == before + 1
        return got, _last_error_text(eng, rid), _health(eng)

    got, err, health = _both(sides, scenario)
    assert err == "RuntimeError: bad weights"
    assert health["status"] == "degraded" and "degraded" in health["flags"]


def _decode_poison(side, eng, poison, attributed):
    """One decode-phase fault on request ``poison``; returns (results, the
    launch sizes the fault's ``when`` saw with the poison id in them)."""
    params = side.serving.SamplingParams(max_new_tokens=4)
    reqs = [eng.add_request(p, params) for p in PROMPTS]
    rid = reqs[poison].request_id
    launches = []

    def attributed_fault(_ctx):
        e = RuntimeError("lora swap failed")
        e.request_id = rid
        raise e

    spec = side.FaultSpec(
        exc=None if attributed else RuntimeError("nan logits"),
        action=attributed_fault if attributed else None,
        when=lambda c: (c.get("phase") == "decode"
                        and rid in c.get("request_ids", ())
                        and not launches.append(len(c["request_ids"]))))
    with side.faults.inject({"serving.step": spec}):
        out = _drain(eng)
    return reqs, rid, out, launches


@pytest.mark.parametrize("attributed", [False, True],
                         ids=["bisected", "attributed"])
def test_poison_decode_isolated(sides, attributed):
    def scenario(side):
        eng = side.engines["small"]
        _, ref = _run(side, eng, PROMPTS)
        before = eng.metrics.requests_errored
        reqs, rid, out, launches = _decode_poison(side, eng, 1, attributed)
        poisoned = out[rid]
        assert poisoned.finish_reason == "error"
        # prefill succeeded, so the poison request kept its first token
        assert len(poisoned.token_ids) == 1
        for i in (0, 2, 3):
            assert out[reqs[i].request_id].token_ids == ref[i][1]
        assert eng.block_manager.num_used == 0
        assert eng.metrics.requests_errored == before + 1
        return launches, _last_error_text(eng, rid), _health(eng)

    launches, err, _ = _both(sides, scenario)
    # attribution short-circuits: one full-batch launch saw the poison
    # id; bisection halves the batch down to the poison request
    assert launches == ([4] if attributed else [4, 2, 1])
    assert err == ("RuntimeError: lora swap failed" if attributed
                   else "RuntimeError: nan logits")


def test_poison_verify_isolated(sides, drafting):
    def scenario(side):
        eng = side.engines["spec"]
        _, ref = _run(side, eng, SPEC_PROMPTS, max_new=8)
        before = (eng.metrics.requests_errored, eng.metrics.verify_steps)
        params = side.serving.SamplingParams(max_new_tokens=8)
        reqs = [eng.add_request(p, params) for p in SPEC_PROMPTS]
        rid = reqs[2].request_id
        launches = []
        spec = side.FaultSpec(
            RuntimeError("draft table torn"),
            when=lambda c: (c.get("phase") == "verify"
                            and rid in c.get("request_ids", ())
                            and not launches.append(
                                len(c["request_ids"]))))
        with side.faults.inject({"serving.step": spec}):
            out = _drain(eng)
        assert out[rid].finish_reason == "error"
        # prefill succeeded, so the poison request kept its first token
        assert len(out[rid].token_ids) == 1
        for i in (0, 1, 3):
            assert out[reqs[i].request_id].token_ids == ref[i][1]
        assert eng.block_manager.num_used == 0
        assert eng.metrics.requests_errored == before[0] + 1
        assert eng.metrics.verify_steps > before[1]
        return (launches, out[rid].token_ids, _last_error_text(eng, rid),
                _health(eng))

    launches, _, err, _ = _both(sides, scenario)
    # the verify launch was bisected down to the poison request
    assert launches == [4, 2, 1]
    assert err == "RuntimeError: draft table torn"


def test_poison_chunked_prefill_stops_its_chunks(sides):
    def scenario(side):
        eng = side.engines["chunked"]
        prompts = [[21, 22, 23, 24, 25, 26, 27], [31, 32, 33], [41, 42]]
        _, ref = _run(side, eng, prompts)
        params = side.serving.SamplingParams(max_new_tokens=4)
        reqs = [eng.add_request(p, params) for p in prompts]
        rid = reqs[0].request_id
        chunks = []
        spec = side.FaultSpec(
            RuntimeError("chunk lost"), at=2,
            when=lambda c: (c.get("phase") == "prefill"
                            and c.get("request_id") == rid
                            and not chunks.append(1)))
        with side.faults.inject({"serving.step": spec}):
            out = _drain(eng)
        assert out[rid].finish_reason == "error"
        assert out[rid].token_ids == []
        for i in (1, 2):
            assert out[reqs[i].request_id].token_ids == ref[i][1]
        # the second chunk raised: no chunk of that request ran after it
        assert len(chunks) == 2
        assert eng.block_manager.num_used == len(eng.prefix_cache)
        return _last_error_text(eng, rid), _health(eng)

    assert _both(sides, scenario)[0] == "RuntimeError: chunk lost"


def test_poison_copy_on_write_goes_on_to_the_next(sides):
    """A copy-on-write that raises at admission poisons that request and
    admission goes on with the next one."""
    def scenario(side):
        eng = side.engines["chunked"]
        shared = [50, 51, 52, 53, 54, 55, 56, 57]
        _run(side, eng, [shared + [58]])          # cache 2 full blocks
        calls = []

        def failing_cow(src, dst):
            calls.append((src, dst))
            raise RuntimeError("copy failed")

        eng._cow = failing_cow
        try:
            # the one-token cap cuts into the last cached block: a COW
            reqs, got = _run(side, eng, [shared, [60, 61, 62]])
        finally:
            del eng._cow
        assert len(calls) == 1
        assert got[0][0] == "error" and got[1][0] == "length"
        assert eng.block_manager.num_used == len(eng.prefix_cache)
        return ([g[:2] for g in got],
                _last_error_text(eng, reqs[0].request_id))

    got, err = _both(sides, scenario)
    assert err == "RuntimeError: copy failed"


# -- port only: a device fault is never contained -----------------------------
def _device_fault(_ctx):
    raise torch.AcceleratorError("CUDA error: an illegal memory access")


@pytest.mark.parametrize("engine,phase,prompts", [
    ("small", "prefill", PROMPTS),
    ("small", "decode", PROMPTS),
    ("spec", "verify", SPEC_PROMPTS),
])
def test_device_fault_reraises_after_one_attempt(sides, engine, phase,
                                                 prompts, drafting,
                                                 tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    eng = sides[1].engines[engine]
    params = serving.SamplingParams(max_new_tokens=6)
    reqs = [eng.add_request(p, params) for p in prompts]
    attempts = []
    spec = FaultSpec(action=_device_fault,
                     when=lambda c: (c.get("phase") == phase
                                     and not attempts.append(c)))
    errored = eng.metrics.requests_errored
    with faults.inject({"serving.step": spec}):
        with pytest.raises(torch.AcceleratorError, match="illegal"):
            _drain(eng)
    # one launch attempt: no bisection, no retry, nothing poisoned
    assert len(attempts) == 1
    assert eng.metrics.requests_errored == errored
    dumps = sorted(tmp_path.glob("paddle_tpu-flight-*.json"))
    payload = json.loads(dumps[-1].read_text())
    assert payload["reason"] == "engine-error"
    assert any(e.get("name") == "engine-error"
               and "AcceleratorError" in e.get("error", "")
               for e in payload["events"])
    # the engine is left as the fault found it: abort what it holds
    for r in reqs:
        eng.abort(r.request_id)
    _drain(eng)
    assert eng.block_manager.num_used == 0
