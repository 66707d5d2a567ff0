"""The port's step observatory (``observability/stepstats.py``), the
compile log (``observability/jit_events.py``) and the flight recorder's
step ring against the JAX package's, on the CPU.

The cases of ``tests/test_stepstats.py`` (its CLI renders wait for the
port's ``observability`` CLI): the sampler's arithmetic on both
packages' ``StepStats``; then twin engines (tiny Llama, MHA and GQA, the
same weights; the JAX engines with the analysis gate off) under the same
greedy traffic — forced speculation rejects, recompute preemption, the
spill tier's restores, a cross-engine migration, an abort — where the
goodput ledger must be EQUAL in all five classes (exact integer counts,
no tolerance), both reconciliation identities must close, and the port's
greedy tokens must equal ``generate`` (exact). ``flops_per_token`` is
equal to the JAX adapter's (exact). Port only: the H100 peak row, the
compile log (one event per program capture, no retrace after warm-up, a
failed build records nothing), and the flight dump carrying the step
samples and the compile log.
"""
import gc
import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import stepstats as jax_stepstats
from paddle_tpu.serving import speculation as jax_speculation
from paddle_tpu.serving.adapter import build_adapter as jax_build_adapter
import torch

from paddle_tpu_torch import serving
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.observability import flight, jit_events
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability.stepstats import (
    PEAK_FLOPS_PER_CHIP,
    StepStats,
    flops_per_token,
    register_stepstats_view,
)
from paddle_tpu_torch.resilience import FaultSpec, faults
from paddle_tpu_torch.serving import speculation
from paddle_tpu_torch.serving.adapter import build_adapter

SMALL = dict(max_batch_slots=4, max_model_len=32, page_size=4,
             prefill_buckets=[32])


@pytest.fixture(scope="module", params=["mha", "gqa"])
def models(request):
    """(JAX model, port model) with the same weights."""
    kv = 2 if request.param == "gqa" else None
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(num_key_value_heads=kv))
    port = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv),
                            device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return jax_model, port


def _engine(S, models, **kw):
    """An engine of package ``S`` (``jax_serving`` or ``serving``) over
    ``SMALL`` + ``kw``."""
    jax_model, port = models
    cfg = dict(SMALL, **kw)
    if S is jax_serving:
        return S.Engine(jax_model, S.EngineConfig(**cfg,
                                                  analysis_check=None))
    return S.Engine(port, S.EngineConfig(**cfg))


def _engines(models, **kw):
    """Twin engines: (JAX, port)."""
    return _engine(jax_serving, models, **kw), _engine(serving, models, **kw)


def _oracle(model, prompt, max_new):
    out = model.generate(torch.tensor([prompt]), max_new_tokens=max_new)
    return out[0, len(prompt):].tolist()


def _reconciles(engine):
    """The two ledger identities (exact)."""
    st, m = engine.stepstats, engine.metrics
    assert (st.useful_tokens + st.wasted_preempt_tokens
            + st.wasted_migration_tokens + st.wasted_aborted_tokens
            == m.prefill_tokens + m.decode_tokens), (
        st.ledger(), m.prefill_tokens, m.decode_tokens)
    assert st.wasted_spec_tokens == m.spec_proposed - m.spec_accepted


def _on_device(kind):
    """An adapter stand-in on a device of type ``kind`` (no weights)."""
    class A:
        device = torch.device(kind)
    return A()


def _thrash_workload(seed=7, n=6):
    rng = np.random.default_rng(seed)
    lens = [int(k) for k in rng.choice([4, 7, 10], n)]
    prompts = [rng.integers(1, 128, k).tolist() for k in lens]
    return prompts, [16 - k for k in lens]


def _generate(S, engine, prompts, max_new):
    outs = engine.generate(
        prompts, [S.SamplingParams(max_new_tokens=k) for k in max_new])
    return [o.token_ids for o in outs]


class TestStepStatsUnit:
    """The sampler alone, both packages' (no engine)."""

    def _fake_adapter(self, n_params=100):
        class A:
            weights = {"w": np.zeros(n_params, dtype="float32"),
                       "t": [torch.zeros(n_params), None]}
        return A()

    def test_flops_per_token_palm_convention(self, models):
        # 2 x parameters: numpy (size) and torch (numel) leaves, None
        # skipped; no weights -> None; the tiny model's count equals the
        # JAX adapter's, exactly
        assert flops_per_token(self._fake_adapter(50)) == 200.0
        assert flops_per_token(object()) is None
        jax_model, port = models
        got = flops_per_token(build_adapter(port))
        assert got == jax_stepstats.flops_per_token(
            jax_build_adapter(jax_model))
        assert got == 2.0 * port.num_params()

    @pytest.mark.parametrize("mod", ["jax", "port"])
    def test_ledger_classes_and_goodput(self, mod):
        st = (jax_stepstats.StepStats if mod == "jax" else StepStats)()
        assert st.goodput_fraction() == 1.0
        st.begin_step()
        st.note_prefill(10)
        st.note_prefill(4, cause="preempt")
        st.note_prefill(3, cause="migration")
        st.note_decode(5)
        st.note_spec_reject(2)
        st.end_step(occupancy=0.5, queue_depth=1)
        assert st.ledger() == {
            "useful": 15, "spec_reject": 2, "preempt_recompute": 4,
            "migration_reprefill": 3, "aborted": 0,
        }
        assert st.goodput_fraction() == 15 / 24
        st.note_abort(5)                         # reclassify, not add
        assert st.useful_tokens == 10
        assert st.wasted_aborted_tokens == 5
        assert st.goodput_fraction() == 10 / 24

    def test_restored_cause_counts_useful(self):
        st = StepStats()
        st.begin_step()
        st.note_prefill(6, cause="restored")
        st.note_prefill(4, cause="preempt")
        st.end_step(occupancy=0.5)
        assert st.useful_tokens == 6
        assert st.wasted_preempt_tokens == 4

    def test_idle_step_skipped_but_gauges_refresh(self):
        st = StepStats()
        st.begin_step()
        assert st.end_step(occupancy=0.0, queue_depth=0) is None
        assert not st.samples
        st.begin_step()
        st.note_decode(1)
        assert st.end_step(occupancy=0.25, queue_depth=2) is not None
        assert st.last_occupancy == 0.25 and st.last_queue_depth == 2

    def test_host_overhead_split_and_sample_shape(self):
        st = StepStats()
        st.begin_step()
        st.record_launch("prefill", 0.010)
        st.record_launch("decode", 0.005)
        st.note_decode(3)
        s = st.end_step(occupancy=0.75, queue_depth=0, kv_free_blocks=5,
                        kv_reclaimable_blocks=2)
        assert s["wall_ms"] >= 0
        # host overhead = step wall minus the launch walls, floored at 0
        # (1e-6 ms: float rounding of the subtraction)
        assert s["host_ms"] == pytest.approx(max(s["wall_ms"] - 15.0, 0.0),
                                             abs=1e-6)
        assert s["launches"] == [("prefill", 10.0), ("decode", 5.0)]
        assert s["tokens"] == 3
        assert s["kv_headroom_blocks"] == 7
        assert sorted(st.digests) == ["decode", "host", "prefill"]

    def test_mfu_window_deterministic(self):
        st = StepStats(adapter=self._fake_adapter(50))   # 200 flops/token
        assert st.mfu() is None
        st.begin_step()
        st.note_decode(10)
        st.end_step(occupancy=1.0)
        t0 = st.samples[0]["ts"]
        # 10 tok * 200 flops / 5 s / 1e11 (the CPU row) = 4e-9 (rel
        # 1e-12: float division only)
        assert st.mfu(now=t0 + 5.0) == pytest.approx(4e-9, rel=1e-12)

    def test_peak_table_by_device_type(self, models):
        # the card's row is the H100 SXM dense bf16 peak; an adapter on
        # the CPU takes the placeholder row; summary() names the peak
        assert PEAK_FLOPS_PER_CHIP["cuda"] == 989e12
        st = StepStats(adapter=_on_device("cuda"))
        assert st.peak_flops_per_chip == 989e12
        assert "H100" in st.summary()["peak_source"]
        st = StepStats(adapter=build_adapter(models[1]))
        assert st.backend == "cpu"
        assert st.summary()["peak_flops_per_chip"] == 1e11
        assert st.summary()["peak_source"] == "CPU placeholder"
        # a device type without a row takes the placeholder too
        assert StepStats(adapter=_on_device("mps")).peak_flops_per_chip \
            == 1e11

    def test_ring_bound_and_validation(self):
        st = StepStats(ring=4)
        for _ in range(10):
            st.begin_step()
            st.note_decode(1)
            st.end_step(occupancy=1.0)
        assert len(st.samples) == 4
        with pytest.raises(ValueError, match="ring"):
            StepStats(ring=0)
        for S in (serving, jax_serving):
            with pytest.raises(ValueError, match="stepstats_ring"):
                S.EngineConfig(max_model_len=32, stepstats_ring=0)

    def test_view_weakref_unregisters_on_drop(self):
        reg = MetricsRegistry()
        st = StepStats()
        st.begin_step()
        st.note_decode(2)
        st.end_step(occupancy=0.5)
        register_stepstats_view(st, "t0", registry=reg)
        text = reg.render_prometheus()
        assert 'class="useful",engine="t0"' in text
        del st
        gc.collect()
        assert 'engine="t0"' not in reg.render_prometheus()


class TestEngineIntegration:
    """Twin engines, the same greedy traffic: equal ledgers."""

    def test_attribution_parity_and_exposition(self, models):
        jeng, eng = _engines(models)
        prompts = [[3, 1, 4, 1], [2, 7, 1, 8, 2], [9, 9]]
        got = _generate(serving, eng, prompts, [6] * 3)
        assert got == _generate(jax_serving, jeng, prompts, [6] * 3)
        assert got == [_oracle(models[1], p, 6) for p in prompts]
        st = eng.stepstats
        assert st.ledger() == jeng.stepstats.ledger()
        _reconciles(eng)
        assert st.goodput_fraction() == 1.0
        assert {"prefill", "decode", "host"} <= set(st.digests)
        assert len(st.samples) >= 1
        h = eng.health()
        assert h["stepstats"]["tokens"]["useful"] == st.useful_tokens
        assert h["kv_headroom_blocks"] == (
            eng.block_manager.num_free + h["kv_reclaimable_blocks"])
        assert h["kv_headroom_bytes_per_chip"] == int(
            h["kv_headroom_blocks"] * eng.pool.block_bytes_per_chip())
        assert h["kv_bytes_per_token_per_chip"] == h["kv_bytes_per_token"]
        assert (h["tp_degree"], h["tp_numerics"], h["tp_devices"]) == (
            1, None, [])
        assert h["decode_kernel_effective"] == "auto"
        assert h["device_memory_budget"] is None
        assert h["predicted_peak_bytes_per_chip"] is None
        assert h["spill"] is None
        jh = jeng.health()
        for key in ("kv_bytes_per_token_per_chip", "kv_headroom_blocks",
                    "kv_headroom_bytes_per_chip", "decode_kernel_effective",
                    "tp_degree"):
            assert h[key] == jh[key], key
        text = obs_metrics.get_registry().render_prometheus()
        eid = f'engine="{eng.engine_id}"'
        for family in (
            "paddle_tpu_serving_step_seconds",
            "paddle_tpu_serving_occupancy",
            "paddle_tpu_serving_goodput_fraction",
            "paddle_tpu_serving_goodput_tokens_total",
            "paddle_tpu_serving_mfu",
            "paddle_tpu_serving_kv_headroom_blocks",
        ):
            assert any(line.startswith(family) and eid in line
                       for line in text.splitlines()), family

    def test_goodput_spec_reject_reconciles(self, models, monkeypatch):
        """An always-wrong drafter: every proposed token is verified and
        rejected — spec_reject == spec_proposed - spec_accepted, on both
        engines alike."""
        jeng, eng = _engines(models, num_blocks=48, prefill_buckets=[16, 32],
                             speculate_tokens=3)
        prompt = [3, 17, 42, 99]
        ref = _oracle(models[1], prompt, 12)

        def wrong(history, k, **kw):
            done = [int(t) for t in history[len(prompt):]]
            if ([int(t) for t in history[:len(prompt)]] == prompt
                    and ref[:len(done)] == done):
                return [(t + 1) % 128 for t in ref[len(done):len(done) + k]]
            return []

        for mod in (speculation, jax_speculation):
            monkeypatch.setattr(mod, "propose", wrong)
        assert _generate(serving, eng, [prompt], [12]) == [ref]
        assert _generate(jax_serving, jeng, [prompt], [12]) == [ref]
        st, m = eng.stepstats, eng.metrics
        assert m.spec_accepted == 0
        assert st.wasted_spec_tokens == m.spec_proposed > 0
        assert st.ledger() == jeng.stepstats.ledger()
        _reconciles(eng)
        assert st.goodput_fraction() < 1.0

    def test_goodput_preemption_reconciles(self, models):
        """A pool too small for the running set forces recompute
        preemption: the re-prefilled context is preempt_recompute, equal
        on both engines, and the identity closes."""
        prompts, max_new = _thrash_workload()
        jeng, eng = _engines(models, num_blocks=10)
        got = _generate(serving, eng, prompts, max_new)
        assert got == _generate(jax_serving, jeng, prompts, max_new)
        assert got == [_oracle(models[1], p, k)
                       for p, k in zip(prompts, max_new)]
        assert eng.metrics.preemptions == jeng.metrics.preemptions >= 1
        st = eng.stepstats
        assert st.wasted_preempt_tokens > 0
        assert st.wasted_migration_tokens == 0
        assert st.ledger() == jeng.stepstats.ledger()
        _reconciles(eng)

    def test_goodput_spill_restore_reconciles(self, models):
        """The same thrash with the host spill tier on: every preemption
        resumes through a restore, so preempt_recompute is 0 on both
        engines and the identity still closes."""
        prompts, max_new = _thrash_workload()
        jeng, eng = _engines(models, num_blocks=10,
                             host_spill_bytes=64 * 1024 * 1024)
        got = _generate(serving, eng, prompts, max_new)
        assert got == _generate(jax_serving, jeng, prompts, max_new)
        assert got == [_oracle(models[1], p, k)
                       for p, k in zip(prompts, max_new)]
        assert eng.metrics.preemptions >= 1
        st = eng.stepstats
        assert eng.spill.stats()["restored_blocks"]["request"] > 0
        assert st.wasted_preempt_tokens == 0
        assert st.wasted_migration_tokens == 0
        assert st.ledger() == jeng.stepstats.ledger()
        _reconciles(eng)

    def test_goodput_migration_reconciles(self, models):
        """release() on one engine, resume() on another: the
        destination's re-prefill over prompt + output[:-1] is all
        migration waste, on both packages' engines."""
        prompt = [3, 17, 42, 99]
        ref = _oracle(models[1], prompt, 10)
        ledgers = []
        for S in (serving, jax_serving):
            e1, e2 = _engine(S, models), _engine(S, models)
            req = e1.add_request(prompt, S.SamplingParams(max_new_tokens=10))
            for _ in range(4):
                e1.step()
            n_before = len(req.output_token_ids)
            assert 1 <= n_before < 10
            assert e1.release(req.request_id) is req
            e2.resume(req)
            assert req.resume_cause == "migration"
            while e2.has_unfinished():
                e2.step()
            assert req.output_token_ids == ref
            st2, m2 = e2.stepstats, e2.metrics
            assert st2.wasted_migration_tokens == m2.prefill_tokens
            assert m2.prefill_tokens == len(prompt) + n_before - 1
            assert st2.wasted_preempt_tokens == 0
            _reconciles(e2)
            _reconciles(e1)
            assert e1.stepstats.wasted_migration_tokens == 0
            ledgers.append((e1.stepstats.ledger(), e2.stepstats.ledger()))
        assert ledgers[0] == ledgers[1]

    def test_abort_reclassifies_emitted_tokens(self, models):
        ledgers = []
        for S, eng in zip((jax_serving, serving), _engines(models)):
            req = eng.add_request([5, 6, 7],
                                  S.SamplingParams(max_new_tokens=20))
            for _ in range(5):
                eng.step()
            n = len(req.output_token_ids)
            assert n >= 1
            st = eng.stepstats
            useful_before = st.useful_tokens
            eng.abort(req.request_id)
            eng.step()   # deliver the aborted RequestOutput
            assert st.wasted_aborted_tokens == n
            assert st.useful_tokens == useful_before - n
            _reconciles(eng)
            ledgers.append(st.ledger())
        assert ledgers[0] == ledgers[1]

    def test_parity_and_zero_new_captures_with_observatory(self, models):
        """Observatory on vs off: identical greedy tokens; a warm engine's
        program counters and the compile log do not move across a second
        pass with it on."""
        port = models[1]
        prompts = [[3, 1, 4, 1], [2, 7, 1], [5, 5]]
        on = serving.Engine(port, serving.EngineConfig(**SMALL))
        off = serving.Engine(port, serving.EngineConfig(**SMALL,
                                                        stepstats=False))
        assert off.stepstats is None
        outs_on = _generate(serving, on, prompts, [6] * 3)
        m = on.metrics
        fields = ("prefill_compiles", "prefill_ext_compiles",
                  "decode_compiles", "verify_compiles", "cow_compiles")
        probes = [getattr(m, f) for f in fields]
        n_log = len(jit_events.compile_log())
        outs_on2 = _generate(serving, on, prompts, [6] * 3)
        assert [getattr(m, f) for f in fields] == probes
        assert len(jit_events.compile_log()) == n_log
        assert outs_on == _generate(serving, off, prompts, [6] * 3) == outs_on2
        assert off.health()["stepstats"] is None

    def test_fault_site_disables_sampler_not_step(self, models):
        eng = serving.Engine(models[1], serving.EngineConfig(**SMALL))
        prompt = [3, 17, 42]
        ref = _oracle(models[1], prompt, 6)
        with faults.inject({"obs.stepstats": FaultSpec(RuntimeError("boom"),
                                                       at=1)}) as inj:
            with pytest.warns(RuntimeWarning, match="step observatory"):
                out = _generate(serving, eng, [prompt], [6])
        assert inj.fired["obs.stepstats"] == 1
        assert out == [ref]                  # the step was unperturbed
        assert eng.stepstats is None         # sampler self-disabled
        assert _generate(serving, eng, [prompt], [6]) == [ref]

    def test_step_samples_reach_the_flight_dump(self, models, tmp_path,
                                                monkeypatch):
        """Every non-idle step pushes one sample (tagged with the engine)
        into the flight recorder's step ring; a dump carries the ring and
        the compile log with every capture the engine made."""
        rec = flight.get_flight_recorder()
        rec.clear()
        jit_events.clear_compile_log()
        eng = serving.Engine(models[1], serving.EngineConfig(**SMALL))
        _generate(serving, eng, [[4, 5, 6], [7, 8]], [4, 4])
        samples = [s for s in flight.step_samples()
                   if s["engine"] == eng.engine_id]
        assert samples and all(s["tokens"] >= 0 for s in samples)
        assert len(samples) == len(eng.stepstats.samples)
        monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
        path = flight.dump("test")
        payload = json.loads(open(path).read())
        assert len(payload["step_samples"]) == len(samples)
        log = payload["compile_log"]
        m = eng.metrics
        assert len(log) == m.prefill_compiles + m.decode_compiles
        assert all(ev["kind"] == "serving" and not ev["retrace"]
                   and ev["signature"].startswith(f"{eng.engine_id}:")
                   for ev in log)
        assert {ev["fn"] for ev in log} == {"serving.prefill",
                                            "serving.decode"}
        assert flight.find_dumps(str(tmp_path)) == [path]
        assert flight.find_dumps(str(tmp_path / "missing")) == []


class TestCompileLog:
    def test_each_capture_logged_once_no_retrace(self, models):
        """Every program an engine builds is one capture event; serving
        more traffic replays them (no event, no retrace)."""
        jit_events.clear_compile_log()
        before = jit_events.retraces_after_warmup("serving")
        eng = serving.Engine(models[1], serving.EngineConfig(
            **SMALL, enable_prefix_cache=True, prefill_chunk_tokens=4))
        prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 11]]
        for _ in range(2):
            _generate(serving, eng, prompts, [4, 4])
        log = jit_events.compile_log()
        m = eng.metrics
        assert len(log) == (m.prefill_compiles + m.prefill_ext_compiles
                            + m.decode_compiles + m.cow_compiles)
        assert m.prefill_ext_compiles >= 1
        assert [ev["trace_no"] for ev in log] == [1] * len(log)
        assert all(ev["elapsed_s"] >= 0 for ev in log)
        assert jit_events.retraces_after_warmup("serving") == before

    def test_second_capture_of_a_signature_is_a_retrace(self):
        jit_events.clear_compile_log()
        before = jit_events.retraces_after_warmup("unit")
        for _ in range(2):
            with jit_events.watch("prog", kind="unit", signature="s"):
                pass
        with jit_events.watch("prog", kind="unit", signature="t"):
            pass
        log = jit_events.compile_log()
        assert [(ev["signature"], ev["trace_no"], ev["retrace"])
                for ev in log] == [("s", 1, False), ("s", 2, True),
                                   ("t", 1, False)]
        assert jit_events.retraces_after_warmup("unit") == before + 1
        events = [e for e in flight.get_flight_recorder().events()
                  if e["category"] == "compile" and e["name"] == "prog"]
        assert events[-1]["signature"] == "t"

    def test_failed_build_records_nothing(self):
        jit_events.clear_compile_log()
        with pytest.raises(ValueError):
            with jit_events.watch("bad", kind="unit", signature="x"):
                raise ValueError("build failed")
        assert jit_events.compile_log() == []
