"""The port's host KV spill tier (``serving/spill.py``, the pool's block
primitives and the engine, prefix-cache, journal and fleet wiring)
against the JAX package's, on the CPU.

The cases of ``tests/test_spill.py`` (its tensor-parallel lane waits for
tensor parallelism, its CLI render for the port's CLI, and its SIGKILL
chaos run is ``slow`` there): the tier alone — the same sequence of puts,
gets and evictions on both packages' ``HostSpillTier`` gives EQUAL
``stats()``; the pool — ``block_signature()`` equal to the JAX pool's for
the same geometry, a restore byte-identical to the spilled blocks, and so
is a disk round trip of bf16 and int8 payloads; twin engines (tiny Llama,
MHA and GQA, the same weights; the JAX engines with the analysis gate
off) under preemption thrash with the tier on — greedy tokens equal
``generate`` and the JAX engine's, spill stats and the goodput ledger
equal, no block leaked, no new program when warm; the ``kv.spill`` and
``kv.restore`` fault sites degrade to recompute (warned once, 0 blocks
leaked); migration and journal replay restore instead of re-prefilling.
Port only: a ``torch.AcceleratorError`` raised inside a spill or a
restore propagates, a pool build that runs out of device memory is
refused as ``EngineOverloadedError`` with its partial allocation
released, the pinned slab's rows, and a partial restore continuing
through the ``prefill_ext`` program. Every comparison is exact: tokens,
counts and bytes (no tolerance).
"""
import gc
import json
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.resilience import FaultSpec as JaxFaultSpec
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.serving import spill as jax_spill
from paddle_tpu.serving.kv_cache import KVPool as JaxKVPool

from paddle_tpu_torch import serving
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.observability.metrics import get_registry
from paddle_tpu_torch.resilience import FaultSpec, faults
from paddle_tpu_torch.serving import fleet as fleet_mod
from paddle_tpu_torch.serving import kv_cache, spill
from paddle_tpu_torch.serving.kv_cache import KVPool
from paddle_tpu_torch.serving.spill import (
    HostSpillTier,
    PinnedSlab,
    is_resource_exhausted,
    payload_nbytes,
)

SMALL = dict(max_batch_slots=4, max_model_len=32, page_size=4,
             prefill_buckets=[32])
PROGRAMS = ("prefill_compiles", "prefill_ext_compiles", "decode_compiles",
            "verify_compiles", "cow_compiles")
SIG = json.dumps(["l1", 2, "none", [[[2, 4], "float32"]]])
# the stats a run's timing moves (wall clock), left out of equality
TIMED = ("restore_ms_mean", "restore_seconds_total")


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
    jax_model, port = models
    cfg = dict(SMALL, **kw)
    if S is jax_serving:
        return S.Engine(jax_model, S.EngineConfig(**cfg,
                                                  analysis_check=None))
    return S.Engine(port, S.EngineConfig(**cfg))


def _oracle(model, prompt, max_new):
    out = model.generate(torch.tensor([prompt]), max_new_tokens=max_new)
    return out[0, len(prompt):].tolist()


def _thrash_workload(seed=7, n=6):
    rng = np.random.default_rng(seed)
    lens = [int(k) for k in rng.choice([4, 7, 10], n)]
    prompts = [rng.integers(1, 128, k).tolist() for k in lens]
    return prompts, [16 - k for k in lens]


def _generate(S, engine, prompts, max_new):
    outs = engine.generate(
        prompts, [S.SamplingParams(max_new_tokens=k) for k in max_new])
    return [o.token_ids for o in outs]


def _stats(tier):
    return {k: v for k, v in tier.stats().items() if k not in TIMED}


def _payload(n_blocks=1, pages=2, fill=1.0):
    """A JAX-form payload: per block (k_layers, v_layers), per layer a
    tuple of numpy leaves."""
    return [(((np.full((pages, 4), fill, dtype=np.float32),),),
             ((np.full((pages, 4), -fill, dtype=np.float32),),))
            for _ in range(n_blocks)]


TIERS = {"jax": jax_spill.HostSpillTier, "port": HostSpillTier}
FAULTS = {"jax": (jax_faults, JaxFaultSpec), "port": (faults, FaultSpec)}


def _both(scenario):
    """``scenario(tier_class, faults, FaultSpec)`` on both packages:
    equal results."""
    got = {name: scenario(cls, *FAULTS[name]) for name, cls in TIERS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


class TestTierUnit:
    """HostSpillTier alone: both packages' tiers, the same sequence."""

    def test_roundtrip_pop_and_signature_gate(self):
        def run(cls, f, fs):
            t = cls(1 << 20)
            p = _payload(fill=3.0)
            assert t.put("prefix:aa", p, SIG, num_tokens=4)
            assert t.has("prefix:aa", SIG)
            # another pool layout MISSES, never corrupts
            assert t.get("prefix:aa", SIG.replace("l1", "l2")) is None
            got = t.get("prefix:aa", SIG, pop=True)
            assert np.array_equal(np.asarray(got[0][0][0][0]), p[0][0][0][0])
            assert t.get("prefix:aa", SIG) is None      # pop is one-shot
            return _stats(t)

        s = _both(run)
        assert s["restore_hits"] == 1 and s["restore_misses"] == 2
        assert s["host_bytes"] == 0

    def test_lru_byte_bound_drops_oldest_without_disk(self):
        one = payload_nbytes(_payload())
        assert one == jax_spill.payload_nbytes(_payload())

        def run(cls, f, fs):
            t = cls(one * 2)
            for i in range(3):
                assert t.put(f"prefix:{i}", _payload(fill=i), SIG)
            assert not t.has("prefix:0", SIG)
            assert t.has("prefix:1", SIG) and t.has("prefix:2", SIG)
            assert not t.put("prefix:big", _payload(n_blocks=3), SIG)
            return _stats(t)

        s = _both(run)
        assert s["host_evictions"] == 1 and s["spill_errors"] == 1

    def test_disk_tier_demotes_and_serves(self, tmp_path):
        one = payload_nbytes(_payload())

        def run(cls, f, fs):
            d = tmp_path / cls.__module__.split(".")[0]
            t = cls(one, spill_dir=str(d))
            assert t.put("prefix:a", _payload(fill=5.0), SIG, num_tokens=2)
            assert t.put("prefix:b", _payload(fill=6.0), SIG, num_tokens=2)
            got = t.get("prefix:a", SIG)                # served from disk
            assert float(got[0][0][0][0][0, 0]) == 5.0
            assert t.disk_tokens("prefix:a") == 2
            # content-keyed names: a fresh tier on the directory finds it
            t2 = cls(one, spill_dir=str(d))
            assert t2.has("prefix:a", SIG)
            assert t2.get("prefix:a", SIG) is not None
            # an oversized payload goes straight to disk
            assert t.put("prefix:c", _payload(n_blocks=2), SIG)
            return _stats(t), _stats(t2)

        s, s2 = _both(run)
        assert s["disk_writes"] == 2 and s["disk_reads"] == 1
        assert s2["disk_reads"] == 1

    def test_peer_tier_lookup_same_host(self):
        def run(cls, f, fs):
            a, b = cls(1 << 20), cls(1 << 20)
            assert a.put("req:7:0", _payload(fill=2.0), SIG, cls="request")
            assert b.has("req:7:0", SIG)
            got = b.get("req:7:0", SIG, pop=True)
            assert float(got[0][0][0][0][0, 0]) == 2.0
            assert not a.has("req:7:0", SIG)
            return _stats(a), _stats(b)

        _both(run)

    def test_injected_faults_degrade_warn_once(self):
        def run(cls, f, fs):
            t = cls(1 << 20)
            with f.inject({"kv.spill": fs(OSError("host alloc failed"))}):
                with pytest.warns(UserWarning, match="kv.spill"):
                    assert t.put("prefix:x", _payload(), SIG) is False
            assert t.put("prefix:x", _payload(), SIG)
            with f.inject({"kv.restore": fs(OSError("torn read"))}):
                with pytest.warns(UserWarning, match="kv.restore"):
                    assert t.get("prefix:x", SIG) is None
            assert t.get("prefix:x", SIG) is not None
            return _stats(t)

        s = _both(run)
        assert s["spill_errors"] == 1 and s["restore_errors"] == 1

    def test_is_resource_exhausted(self):
        assert is_resource_exhausted(
            RuntimeError("RESOURCE_EXHAUSTED: failed to allocate"))
        assert is_resource_exhausted(MemoryError("out of memory"))
        assert is_resource_exhausted(torch.OutOfMemoryError("no room"))
        assert is_resource_exhausted(RuntimeError(
            "CUDA out of memory. Tried to allocate 2.00 GiB"))
        assert not is_resource_exhausted(ValueError("bad shape"))

    def test_accelerator_error_is_never_degraded(self):
        t = HostSpillTier(1 << 20)
        for site, call in (
                ("kv.spill", lambda: t.put("prefix:y", _payload(), SIG)),
                ("kv.restore", lambda: t.get("prefix:y", SIG))):
            with faults.inject({site: FaultSpec(
                    torch.AcceleratorError("CUDA error: illegal address"))}):
                with pytest.raises(torch.AcceleratorError):
                    call()
        s = t.stats()
        assert s["spill_errors"] == 0 and s["restore_errors"] == 0

    def test_pinned_slab_rows_and_release(self):
        slab = PinnedSlab(64, 6)
        assert slab.alloc(7) is None
        a = slab.alloc(2)
        b = slab.alloc(3)
        assert (a, b) == ([0, 1], [2, 3, 4])
        slab.free(a)
        assert slab.alloc(3) == [0, 1, 5]
        assert PinnedSlab.runs([0, 1, 5, 6, 9]) == [(0, 2), (5, 2), (9, 1)]
        slab.free(b)
        assert slab.num_free == 3
        # a tier drops (and so releases) a slab payload it evicts
        pool = KVPool(1, 2, 8, 4, 8, device="cpu")
        slab = PinnedSlab(pool.layout.row_bytes, 4)
        t = HostSpillTier(pool.layout.nbytes * 2)
        for i in range(3):
            assert t.put(f"prefix:{i}", pool.read_blocks([i], slab), "s")
        assert slab.num_free == 2           # the oldest was evicted
        got = t.get("prefix:2", "s", pop=True)
        assert slab.num_free == 2           # popped: the caller owns it
        got.release()
        got.release()                       # idempotent
        assert slab.num_free == 3
        t.clear()
        assert slab.num_free == 4


def _random_pool(quant, dtype, seed=0):
    pool = KVPool(2, 2, 6, 4, 8, dtype=dtype, device="cpu",
                  quant_dtype=quant)
    g = torch.Generator().manual_seed(seed)
    for entry in pool.k + pool.v:
        for t in (entry if isinstance(entry, tuple) else (entry,)):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-128, 128, t.shape, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g))
    return pool


def _block_bytes(pool, b):
    return [t[:, b].contiguous().view(torch.uint8)
            for entry in pool.k + pool.v
            for t in (entry if isinstance(entry, tuple) else (entry,))]


POOLS = [(None, torch.float32), (None, torch.bfloat16),
         (None, torch.float16), ("int8", torch.bfloat16)]


class TestPoolPrimitives:
    @pytest.mark.parametrize("quant,dtype", POOLS)
    def test_block_signature_equals_jax(self, quant, dtype):
        name = str(dtype).replace("torch.", "")
        for layers, hkv, bs, d in ((2, 4, 4, 16), (12, 16, 16, 128)):
            port = KVPool(layers, hkv, 3, bs, d, dtype=dtype, device="cpu",
                          quant_dtype=quant)
            ref = JaxKVPool(layers, hkv, 3, bs, d, dtype=name,
                            quant_dtype=quant)
            assert port.block_signature() == ref.block_signature()
            assert port.layout.nbytes == jax_spill.payload_nbytes(
                [ref.read_block(0)])
            assert port.bytes_per_token_per_chip() == \
                port.bytes_per_token()
            assert port.block_bytes_per_chip() * port.num_blocks == \
                port.nbytes()

    @pytest.mark.parametrize("quant,dtype", POOLS)
    @pytest.mark.parametrize("split_rows", [False, True])
    def test_read_write_blocks_byte_identical(self, quant, dtype,
                                              split_rows):
        pool = _random_pool(quant, dtype)
        sink_before = _block_bytes(pool, pool.sink_page)
        want = {b: _block_bytes(pool, b) for b in (4, 1, 2)}
        # an exact fit in one run, or rows split around a taken one
        slab = PinnedSlab(pool.layout.row_bytes, 8 if split_rows else 3)
        if split_rows:
            slab.free(slab.alloc(2)[:1])     # row 1 taken: [0], [2, 3]
        payload = pool.read_blocks([4, 1, 2], slab)
        assert len(payload.runs) == (2 if split_rows else 1)
        assert len(payload) == 3
        assert payload.nbytes == 3 * pool.layout.nbytes == \
            payload_nbytes(list(payload))
        pool.write_blocks([0, 3, 5], payload)
        for src, dst in ((4, 0), (1, 3), (2, 5)):
            assert all(torch.equal(a, b) for a, b in
                       zip(_block_bytes(pool, dst), want[src]))
        # a JAX-form snapshot (numpy leaves) writes the same bytes
        snap = pool.read_block(1)
        other = _random_pool(quant, dtype, seed=1)
        other.write_block(2, [[[
            leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
            for leaf in layer] for layer in side] for side in snap])
        assert all(torch.equal(a, b) for a, b in
                   zip(_block_bytes(other, 2), want[1]))
        assert all(torch.equal(a, b) for a, b in
                   zip(_block_bytes(pool, pool.sink_page), sink_before))
        payload.release()
        assert slab.num_free == (7 if split_rows else 3)

    def test_blocks_are_checked(self):
        pool = _random_pool(None, torch.float32)
        slab = PinnedSlab(pool.layout.row_bytes, 2)
        with pytest.raises(ValueError, match="outside pool"):
            pool.read_blocks([pool.sink_page], slab)
        # a slab that cannot take the handle raises, never allocates; a
        # failed read hands its rows back
        with pytest.raises(RuntimeError, match="2 free slab rows"):
            pool.read_blocks([0, 1, 2], slab)
        assert slab.num_free == 2
        with pytest.raises(ValueError, match="outside pool"):
            pool.write_block(-1, pool.read_block(0))
        snap = pool.read_block(0)
        bad = (snap[0][:1], snap[1])
        with pytest.raises(ValueError, match="k/v layers"):
            pool.write_block(1, bad)
        wrong = _random_pool(None, torch.bfloat16).read_block(0)
        with pytest.raises(ValueError, match="does not match"):
            pool.write_block(1, wrong)

    @pytest.mark.parametrize("quant,dtype", [(None, torch.bfloat16),
                                             ("int8", torch.bfloat16)])
    def test_disk_round_trip_byte_identical(self, quant, dtype, tmp_path):
        pool = _random_pool(quant, dtype)
        want = [_block_bytes(pool, b) for b in (1, 3)]
        tier = HostSpillTier(1, spill_dir=str(tmp_path))   # all to disk
        slab = PinnedSlab(pool.layout.row_bytes, 4)
        sig = pool.block_signature()
        assert tier.put("req:1:0", pool.read_blocks([1, 3], slab), sig,
                        num_tokens=7, cls="request")
        assert slab.num_free == 4              # written out, rows back
        (path,) = list(tmp_path.iterdir())
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
        assert meta["signature"] == sig and meta["num_tokens"] == 7
        assert set(meta["dtypes"]) == ({"int8", "float32"} if quant
                                       else {"bfloat16"})
        fresh = HostSpillTier(1, spill_dir=str(tmp_path))
        got = fresh.get("req:1:0", sig, pop=True)
        assert len(got) == 2
        target = _random_pool(quant, dtype, seed=5)
        target.write_blocks([0, 4], got)
        for dst, w in zip((0, 4), want):
            assert all(torch.equal(a, b)
                       for a, b in zip(_block_bytes(target, dst), w))
        assert not list(tmp_path.iterdir())     # popped off the disk


class TestEngineSpill:
    def test_thrash_restores_instead_of_recomputing(self, models):
        """Greedy tokens under thrash equal generate and the JAX engine's,
        the spill stats and the ledger are equal, recompute waste is 0,
        a warm second pass builds no program, no block leaks."""
        prompts, max_new = _thrash_workload()
        kw = dict(num_blocks=10, host_spill_bytes=64 * 1024 * 1024)
        jeng = _engine(jax_serving, models, **kw)
        eng = _engine(serving, models, **kw)
        got = _generate(serving, eng, prompts, max_new)
        assert got == _generate(jax_serving, jeng, prompts, max_new)
        assert got == [_oracle(models[1], p, k)
                       for p, k in zip(prompts, max_new)]
        assert eng.metrics.preemptions == jeng.metrics.preemptions >= 1
        assert _stats(eng.spill) == _stats(jeng.spill)
        tier = eng.spill.stats()
        assert tier["restored_blocks"]["request"] > 0
        assert tier["restore_hit_rate"] == 1.0
        assert eng.stepstats.wasted_preempt_tokens == 0
        assert eng.stepstats.ledger() == jeng.stepstats.ledger()
        before = {k: getattr(eng.metrics, k) for k in PROGRAMS}
        _generate(serving, eng, prompts, max_new)
        assert {k: getattr(eng.metrics, k) for k in PROGRAMS} == before
        assert eng.block_manager.num_used == 0
        assert eng.health()["spill"]["restored_blocks"]["request"] > 0
        # every handle was popped or discarded: the slab is whole again
        assert eng.spill.slab.num_free == eng.spill.slab.num_rows

    @pytest.mark.parametrize("site", ["kv.spill", "kv.restore"])
    def test_injected_fault_degrades_to_recompute(self, models, site):
        """A spill or restore fault on every call: preemption falls back
        to recompute on both engines alike — tokens exact, warned once,
        counted, no leak, the ledger equal and its identity closed."""
        prompts, max_new = _thrash_workload(seed=3)
        kw = dict(num_blocks=10, host_spill_bytes=64 * 1024 * 1024)
        results = {}
        for S, f, fs in ((jax_serving, jax_faults, JaxFaultSpec),
                         (serving, faults, FaultSpec)):
            eng = _engine(S, models, **kw)
            with f.inject({site: fs(OSError("host tier down"), every=1)}):
                with pytest.warns(UserWarning, match=site):
                    got = _generate(S, eng, prompts, max_new)
            assert eng.block_manager.num_used == 0
            st, m = eng.stepstats, eng.metrics
            assert (st.useful_tokens + st.wasted_preempt_tokens
                    + st.wasted_migration_tokens + st.wasted_aborted_tokens
                    == m.prefill_tokens + m.decode_tokens)
            assert st.wasted_preempt_tokens > 0
            results[S.__name__] = (got, _stats(eng.spill), st.ledger())
        got, stats, ledger = results["paddle_tpu_torch.serving"]
        assert got == [_oracle(models[1], p, k)
                       for p, k in zip(prompts, max_new)]
        # by design the port frees a handle whose restore failed; the
        # JAX tier keeps it until its LRU drops it
        held = ("host_bytes", "host_entries")
        jax_got, jax_stats, jax_ledger = results["paddle_tpu.serving"]
        assert (stats["host_bytes"], stats["host_entries"]) == (0, 0)
        assert (jax_got, jax_ledger) == (got, ledger)
        assert {k: v for k, v in jax_stats.items() if k not in held} == {
            k: v for k, v in stats.items() if k not in held}
        if site == "kv.spill":
            assert jax_stats == stats
        errors = "spill_errors" if site == "kv.spill" else "restore_errors"
        assert stats[errors] > 0

    def test_restore_write_oom_degrades(self, models, monkeypatch):
        """An out-of-memory restore write walks the ladder (reclaim, retry,
        recompute) instead of unwinding the step."""
        prompts, max_new = _thrash_workload(seed=11)
        eng = _engine(serving, models, num_blocks=10,
                      host_spill_bytes=64 * 1024 * 1024)

        def oom(self, block_ids, payload):
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")

        monkeypatch.setattr(KVPool, "write_blocks", oom)
        with pytest.warns(UserWarning, match="KV restore failed"):
            got = _generate(serving, eng, prompts, max_new)
        monkeypatch.undo()
        assert got == [_oracle(models[1], p, k)
                       for p, k in zip(prompts, max_new)]
        assert eng.block_manager.num_used == 0
        assert eng.spill.stats()["restore_errors"] > 0
        assert eng.spill.slab.num_free == eng.spill.slab.num_rows

    def test_accelerator_error_inside_spill_propagates(self, models):
        """A CUDA error is sticky for the process: the engine never
        degrades it to recompute, neither in a spill nor in a restore."""
        prompts, max_new = _thrash_workload()
        for site in ("kv.spill", "kv.restore"):
            eng = _engine(serving, models, num_blocks=10,
                          host_spill_bytes=64 * 1024 * 1024)
            with faults.inject({site: FaultSpec(torch.AcceleratorError(
                    "CUDA error: an illegal memory access"))}):
                with pytest.raises(torch.AcceleratorError):
                    _generate(serving, eng, prompts, max_new)
            assert eng.spill.stats()["spill_errors"] == 0
            assert eng.spill.stats()["restore_errors"] == 0

    def test_pool_build_oom_is_overload_and_releases(self, models,
                                                     monkeypatch):
        """The pool's allocation running out of device memory part way:
        ``EngineOverloadedError`` naming the knob, every plane allocated
        before the failure released, and the same process builds a pool
        that fits and serves."""
        made, real_zeros = [], torch.zeros

        def zeros(*a, **kw):
            if len(made) == 5:
                raise torch.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 80.00 GiB")
            t = real_zeros(*a, **kw)
            made.append(weakref.ref(t))
            return t

        # the int8 pool of the 2-layer model makes 8 planes: the 6th fails
        monkeypatch.setattr(kv_cache.torch, "zeros", zeros)
        with pytest.raises(serving.EngineOverloadedError,
                           match="num_blocks") as err:
            _engine(serving, models, num_blocks=64, kv_cache_dtype="int8")
        monkeypatch.undo()
        del err
        gc.collect()
        assert len(made) == 5 and all(r() is None for r in made)
        eng = _engine(serving, models)
        assert _generate(serving, eng, [[3, 1, 4]], [4]) == [
            _oracle(models[1], [3, 1, 4], 4)]

    def test_release_resume_restores_across_engines(self, models):
        """Same-process migration: release() parks the KV, the survivor's
        admission restores it through the peer tier — no re-prefill on
        the destination, as in the JAX engines."""
        prompt = [3, 17, 42, 99]
        ref = _oracle(models[1], prompt, 10)
        kw = dict(num_blocks=10, host_spill_bytes=64 * 1024 * 1024)
        seen = []
        for S in (jax_serving, serving):
            e1, e2 = _engine(S, models, **kw), _engine(S, models, **kw)
            req = e1.add_request(prompt, S.SamplingParams(max_new_tokens=10))
            for _ in range(4):
                e1.step()
            n_before = len(req.output_token_ids)
            assert 1 <= n_before < 10
            assert e1.release(req.request_id) is req
            assert req.spill_key is not None
            e2.resume(req)
            while e2.has_unfinished():
                e2.step()
            assert req.output_token_ids == ref
            assert req.resume_cause == "restored"
            assert e2.metrics.prefill_tokens == 0
            assert e2.stepstats.wasted_migration_tokens == 0
            seen.append((_stats(e1.spill), _stats(e2.spill),
                         e2.stepstats.ledger()))
        assert seen[0] == seen[1]
        assert seen[1][1]["restored_blocks"]["request"] > 0

    @pytest.mark.parametrize("end", ["abort_on_peer", "peer_without_tier",
                                     "fleet_pending_abort"])
    def test_spent_handle_leaves_nothing_in_the_source_tier(self, models,
                                                            end):
        """Port only: a handle given up anywhere but its own engine is
        freed in the tier that holds it — the request aborted on a peer,
        resumed on a peer without a tier (recomputed there, tokens equal
        generate), or aborted while parked in a fleet's pending queue.
        The source tier then holds 0 bytes and every slab row, and the
        request no longer references it."""
        prompt = [3, 17, 42, 99]
        kw = dict(num_blocks=10, host_spill_bytes=64 * 1024 * 1024)
        e1 = _engine(serving, models, **kw)
        req = e1.add_request(prompt,
                             serving.SamplingParams(max_new_tokens=10))
        for _ in range(4):
            e1.step()
        assert e1.release(req.request_id) is req
        assert e1.spill.stats()["host_bytes"] > 0
        if end == "abort_on_peer":
            e2 = _engine(serving, models, **kw)
            e2.resume(req)
            assert e2.abort(req.request_id)
            e2.step()
            assert req.finish_reason == "aborted"
        elif end == "peer_without_tier":
            e2 = _engine(serving, models, num_blocks=10)
            e2.resume(req)
            while e2.has_unfinished():
                e2.step()
            assert req.output_token_ids == _oracle(models[1], prompt, 10)
            assert req.resume_cause == "migration"
        else:
            # parked unplaced, as a failed-over request waits for a
            # replica, then aborted by its client
            fleet = serving.Fleet(models[1], serving.EngineConfig(**SMALL),
                                  serving.FleetConfig(num_replicas=1))
            freq = fleet_mod.FleetRequest(prompt, req.sampling_params,
                                          req.request_id)
            freq.request = req
            fleet._pending.append(freq)
            assert fleet.abort(req.request_id)
            assert freq.output.finish_reason == "aborted"
        st = e1.spill.stats()
        assert (st["host_bytes"], st["host_entries"]) == (0, 0)
        assert e1.spill.slab.num_free == e1.spill.slab.num_rows
        assert (req.spill_key, req.spill_tier, req.spill_tokens) == (
            None, None, 0)

    def test_prefix_chain_spill_restores_byte_identical(self, models):
        """LRU-evicted chains come back from the host tier: the same
        tokens as the first pass, prefix_restores counted, the stats equal
        to the JAX engine's."""
        cfg = dict(max_batch_slots=2, max_model_len=48, page_size=4,
                   num_blocks=24, prefill_buckets=[48],
                   enable_prefix_cache=True, prefix_cache_blocks=4,
                   host_spill_bytes=64 * 1024 * 1024)
        base = list(range(2, 14))           # 3 full shared blocks
        seen = []
        gc.collect()            # no earlier engine's tier left as a peer
        for S, model, extra in ((jax_serving, models[0],
                                 dict(analysis_check=None)),
                                (serving, models[1], {})):
            e = S.Engine(model, S.EngineConfig(**cfg, **extra))
            params = S.SamplingParams(max_new_tokens=6)
            o1 = e.generate([base + [20, 21]], params)[0].token_ids
            e.generate([list(range(60, 90))], params)   # churn the LRU
            assert e.spill.stats()["spilled_blocks"]["prefix"] > 0
            o2 = e.generate([base + [20, 21]], params)[0].token_ids
            assert o2 == o1
            assert e.metrics.prefix_restores > 0
            assert e.spill.stats()["restored_blocks"]["prefix"] > 0
            seen.append((o1, _stats(e.spill), e.metrics.prefix_restores,
                         e.metrics.prefix_hit_tokens))
        assert seen[0] == seen[1]
        assert seen[1][0] == _oracle(models[1], base + [20, 21], 6)

    def test_partial_restore_continues_through_prefill_ext(self, models):
        """A request released mid-prefill (chunked) parks the chunks it
        has; its re-admission restores them and the rest of the prompt
        continues through the continuation program."""
        prompt = list(range(3, 16))
        ref = _oracle(models[1], prompt, 5)
        kw = dict(num_blocks=24, prefill_chunk_tokens=4,
                  host_spill_bytes=64 * 1024 * 1024)
        seen = []
        for S in (jax_serving, serving):
            e1, e2 = _engine(S, models, **kw), _engine(S, models, **kw)
            req = e1.add_request(prompt, S.SamplingParams(max_new_tokens=5))
            e1.step()
            e1.step()
            assert req.num_cached == 8 and not req.output_token_ids
            assert e1.release(req.request_id) is req
            assert req.spill_tokens == 8
            e2.resume(req)
            while e2.has_unfinished():
                e2.step()
            assert req.output_token_ids == ref
            m2 = e2.metrics
            assert m2.prefill_tokens == len(prompt) - 8
            seen.append((m2.prefill_tokens, m2.prefill_chunks,
                         e2.stepstats.ledger(), _stats(e2.spill)))
        assert seen[0] == seen[1]

    def test_journal_reanchors_handle_through_disk(self, models, tmp_path):
        """Crash re-anchor: a released request's handle rides the ADMIT;
        a fresh incarnation on the same journal and spill_dir restores
        from disk instead of re-prefilling."""
        jdir, sdir = str(tmp_path / "wal"), str(tmp_path / "spill")
        kw = dict(journal=jdir, host_spill_bytes=1, spill_dir=sdir)
        e1 = _engine(serving, models, **kw)
        prompt = [5, 9, 23, 31]
        ref = _oracle(models[1], prompt, 8)
        req = e1.add_request(prompt, serving.SamplingParams(max_new_tokens=8))
        for _ in range(3):
            e1.step()
        n_before = len(req.output_token_ids)
        assert 1 <= n_before < 8
        rid = req.request_id
        assert e1.release(rid) is req
        assert req.spill_key is not None
        e1.journal.flush(force=True)
        e1.journal.close()
        del e1, req
        gc.collect()                        # no peer tier left
        e2 = _engine(serving, models, **kw)
        assert e2.has_unfinished()
        done = {}
        while e2.has_unfinished():
            for o in e2.step():
                done[o.request_id] = o
        assert done[rid].token_ids == ref
        s = e2.spill.stats()
        assert s["disk_reads"] > 0
        assert s["restored_blocks"]["request"] > 0
        assert e2.metrics.prefill_tokens == 0
        assert e2.health()["spill"]["disk_reads"] == s["disk_reads"]


class TestViews:
    def test_collector_exports(self, models):
        eng = _engine(serving, models, num_blocks=10,
                      host_spill_bytes=64 * 1024 * 1024)
        prompts, max_new = _thrash_workload()
        _generate(serving, eng, prompts, max_new)
        text = get_registry().render_prometheus()
        eid = f'engine="{eng.engine_id}"'
        for family in ("paddle_tpu_serving_spill_host_bytes{",
                       "paddle_tpu_serving_spill_restored_bytes_total{",
                       "paddle_tpu_serving_spill_restore_hit_rate{",
                       "paddle_tpu_serving_spill_errors_total{"):
            assert any(line.startswith(family) and eid in line
                       for line in text.splitlines()), family
        assert 'class="request"' in text

    def test_fleet_scale_down_restores_through_the_peer_tier(self, models):
        """A scale-down migrates the in-flight requests; the survivor
        restores their parked KV (no re-prefill), tokens equal generate,
        and the fleet exports each replica's restore hit rate."""
        geo = dict(max_batch_slots=4, max_model_len=32, page_size=4,
                   prefill_buckets=[32], host_spill_bytes=64 * 1024 * 1024)
        fleet = serving.Fleet(models[1], serving.EngineConfig(**geo),
                              serving.FleetConfig(num_replicas=2))
        prompts = [[3, 1, 4, 1], [2, 7, 1, 8], [9, 9, 5], [6, 2, 6]]
        reqs = [fleet.add_request(p, serving.SamplingParams(
            max_new_tokens=10)) for p in prompts]
        for _ in range(4):
            fleet.step()
        victim = fleet.replicas[0]
        assert any(r is not None for r in victim.engine.slots)
        survivor = fleet.replicas[1].engine
        prefilled = survivor.metrics.prefill_tokens
        fleet.scale_down(replica=victim.name)
        gc.collect()            # the victim's engine is dropped and gone
        done = {}
        for _ in range(200):
            for o in fleet.step():
                done[o.request_id] = o
            if len(done) == len(reqs):
                break
        assert [done[r.request_id].token_ids for r in reqs] == [
            _oracle(models[1], p, 10) for p in prompts]
        assert survivor.metrics.prefill_tokens == prefilled
        assert survivor.spill.stats()["restored_blocks"]["request"] > 0
        text = get_registry().render_prometheus()
        assert any(
            line.startswith("paddle_tpu_fleet_replica_spill_restore_hit_rate")
            and fleet.replicas[0].name in line
            for line in text.splitlines())
