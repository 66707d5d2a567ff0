"""The port's prefix cache, chunked prefill and copy-on-write, on the CPU,
against the JAX package on the same numpy inputs and weights.

* ``PrefixCache``: the JAX package's three ``TestPrefixCacheUnit`` cases
  (``tests/test_serving.py:1088``), run on both implementations, and the
  same sequence of register/lookup/commit/reclaim calls giving the same
  matches, counters and chain digests on both.
* ``adapter.prefill_ext`` against the JAX adapter's ``prefill_ext`` on
  identical pools (MHA and GQA; cache_len 0, page-aligned and unaligned;
  float and int8 pools): logits and float pages within rtol 1e-4 / atol
  1e-4 (the decode-logits check of ``tests/test_torch_kv_int8.py``: both
  sides run f32 products whose last bits differ between the frameworks),
  int8 pages within one quantization step, scales rtol 1e-5.
* ``kernels.paged_prefill_ref`` (the plain version of the continuation
  kernel) against JAX's masked form (``_gather_context`` then ``_sdpa``)
  within rtol 1e-4 / atol 1e-5, float and int8 pages, MHA and GQA.
* The engine with the prefix cache and chunked prefill on, as the JAX
  ``prefix_engine`` fixture configures it: the seven
  ``TestPrefixCacheChunkedPrefill`` contracts (``tests/test_serving.py:
  581-845``) but the analysis gate, which is not ported, and greedy
  tokens equal to the JAX engine's on converted weights; the compile
  probes ``prefill_ext_compiles <= buckets`` and ``cow_compiles <= 1``;
  the continuation and copy-on-write programs shape-static and free of
  host syncs; ``paged_prefill`` on a CUDA-less tensor takes the plain
  version (its raising on a CUDA tensor it does not take is in
  ``tests/test_torch_build.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.kernels.pallas import paged_attention as jpa
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.impl.nn_ops import scaled_dot_product_attention as jsdpa
from paddle_tpu.serving import prefix_cache as jax_prefix_cache
from paddle_tpu.serving.adapter import LlamaServingAdapter as JaxAdapter
from paddle_tpu.serving.adapter import _gather_context
from paddle_tpu_torch.kernels import _build, launch_counts
from paddle_tpu_torch.kernels import paged_prefill as ppf
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.serving import (
    BlockManager,
    Engine,
    EngineConfig,
    PrefixCache,
    RequestState,
    SamplingParams,
    prompt_chain_digests,
)
from paddle_tpu_torch.serving.adapter import LlamaServingAdapter

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = {"port": (BlockManager, PrefixCache),
         "jax": (jax_serving.BlockManager, jax_prefix_cache.PrefixCache)}


# ------------------------------------------------------------ PrefixCache
@pytest.mark.parametrize("impl", ["port", "jax"])
def test_register_retains_and_eviction_releases(impl):
    bm_cls, pc_cls = IMPLS[impl]
    bm = bm_cls(8, 4)
    pc = pc_cls(bm, capacity_blocks=2)
    blocks = bm.allocate(3)
    assert bm.high_water == 3
    pc.register(list(range(12)), blocks, 12)
    # budget 2: the tail entry was evicted leaf-first immediately
    assert len(pc) == 2
    bm.free(blocks)   # the owning request releases
    assert bm.num_used == 2
    assert pc.reclaimable_blocks() == 2
    assert pc.reclaim(2) == 2
    assert bm.num_used == 0 and bm.num_free == 8
    with pytest.raises(RuntimeError, match="double free"):
        bm.free([blocks[0]])
    with pytest.raises(RuntimeError, match="fork of free"):
        bm.fork([blocks[0]])


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_lookup_chain_cap_and_cow(impl):
    bm_cls, pc_cls = IMPLS[impl]
    bm = bm_cls(8, 4)
    pc = pc_cls(bm, capacity_blocks=8)
    blocks = bm.allocate(2)
    prompt = list(range(8))
    pc.register(prompt, blocks, 8)
    m = pc.lookup(prompt, limit=8)
    assert m.cache_len == 8
    assert m.shared_blocks == blocks and m.cow_src is None
    # the one-token cap cuts into the last block: it becomes the COW
    # source, only the first is forked
    m = pc.lookup(prompt, limit=7)
    assert m.cache_len == 7
    assert m.shared_blocks == blocks[:1]
    assert m.cow_src == blocks[1]
    m = pc.lookup(prompt[:4] + [99, 98, 97, 96], limit=7)
    assert m.cache_len == 4 and m.shared_blocks == blocks[:1]
    assert pc.lookup(list(range(100, 108)), limit=7) is None
    assert pc.lookup(prompt[:3], limit=2) is None


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_reclaim_skips_blocks_live_requests_hold(impl):
    bm_cls, pc_cls = IMPLS[impl]
    bm = bm_cls(8, 4)
    pc = pc_cls(bm, capacity_blocks=8)
    blocks = bm.allocate(2)
    pc.register(list(range(8)), blocks, 8)
    bm.fork(blocks)   # a second request reads them
    bm.free(blocks)   # first owner gone; cache ref + reader remain
    assert pc.reclaimable_blocks() == 0
    assert pc.reclaim(2) == 0
    bm.free(blocks)   # reader done
    assert pc.reclaimable_blocks() == 2
    # protect the chain ROOT: the leaf frees, the root survives
    assert pc.reclaim(5, protect={blocks[0]}) == 1
    assert bm.ref_count(blocks[0]) == 1
    assert bm.ref_count(blocks[1]) == 0


class _Metrics:
    prefix_hits = prefix_hit_tokens = prefix_evictions = 0


def _script(bm_cls, pc_cls):
    """One sequence of cache calls; everything it observes."""
    bm, m = bm_cls(24, 4), _Metrics()
    pc = pc_cls(bm, capacity_blocks=6, metrics=m)
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 100, 9).tolist()
    seen = []
    for i in range(6):
        prompt = shared + rng.randint(1, 100, 3 + 2 * i).tolist()
        match = pc.lookup(prompt, limit=len(prompt) - 1)
        n_fork = match.num_shared if match else 0
        blocks = bm.allocate(-(-len(prompt) // 4) - n_fork)
        if match:
            bm.fork(match.shared_blocks)
            blocks = match.shared_blocks + blocks
            pc.commit(match)
        seen.append((None if match is None else
                     (match.cache_len, match.shared_blocks, match.cow_src),
                     len(pc), pc.reclaimable_blocks()))
        pc.register(prompt, blocks, len(prompt))
        if i % 2:
            bm.free(blocks)
            seen.append(("reclaim", pc.reclaim(2, protect=blocks[:1])))
    seen.append((m.prefix_hits, m.prefix_hit_tokens, m.prefix_evictions,
                 bm.num_used, list(pc.chain_digests())))
    return seen


def test_same_calls_same_results_as_jax():
    assert _script(*IMPLS["port"]) == _script(*IMPLS["jax"])
    tokens = list(range(3, 40))
    assert prompt_chain_digests(tokens, 8) == \
        jax_prefix_cache.prompt_chain_digests(tokens, 8)


# ----------------------------------------------------- paged_prefill_ref
def _pages(rng, hkv, n_pages, page, d, quant):
    """(JAX entry, port entry) of one layer: the same pages, the port's
    with its sink page."""
    x = rng.randn(hkv, n_pages, page, d).astype(np.float32)
    if not quant:
        sink = np.zeros((hkv, 1, page, d), np.float32)
        return jnp.asarray(x), torch.from_numpy(
            np.concatenate([x, sink], axis=1))
    q8, sc = (np.asarray(a) for a in jpa.quantize_tokens(jnp.asarray(x)))
    port = (torch.from_numpy(np.concatenate(
                [q8, np.zeros((hkv, 1, page, d), np.int8)], axis=1)),
            torch.from_numpy(np.concatenate(
                [sc, np.zeros((hkv, 1, page), np.float32)], axis=1)))
    return (jnp.asarray(q8), jnp.asarray(sc)), port


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("cache_len,length", [(0, 8), (8, 5), (6, 3),
                                              (13, 1)])
def test_paged_prefill_ref_matches_jax_masked_form(quant, hq, hkv,
                                                   cache_len, length):
    rng = np.random.RandomState(cache_len + 3 * length)
    page, d, s = 4, 16, 8
    jk, tk = _pages(rng, hkv, 7, page, d, quant)
    jv, tv = _pages(rng, hkv, 7, page, d, quant)
    table = np.array([5, 0, 6, 2, 3], np.int32)     # capacity 20
    q = rng.randn(s, hq, d).astype(np.float32)
    kc = _gather_context(jk, jnp.asarray(table))[None]
    vc = _gather_context(jv, jnp.asarray(table))[None]
    if hkv != hq:
        kc = jnp.repeat(kc, hq // hkv, axis=2)
        vc = jnp.repeat(vc, hq // hkv, axis=2)
    pos = cache_len + np.arange(s)
    keep = (np.arange(table.size * page)[None, :] <= pos[:, None])
    ref = np.asarray(jsdpa(jnp.asarray(q)[None], kc, vc,
                           jnp.asarray(keep)[None, None]))[0]
    out = ppf.paged_prefill_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.tensor(cache_len, dtype=torch.int32),
        torch.tensor(length, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy()[:length], ref[:length],
                               **ATTN_TOL)
    # the wrapper takes the plain version for CPU tensors, uncounted
    _build.reset_launch_counts()
    got = ppf.paged_prefill(torch.from_numpy(q), tk, tv,
                            torch.from_numpy(table),
                            torch.tensor(cache_len, dtype=torch.int32),
                            torch.tensor(length, dtype=torch.int32))
    assert launch_counts()["paged_prefill"] == 0
    torch.testing.assert_close(got, out, rtol=0, atol=0)


# ------------------------------------------------------- prefill_ext
def _models(kv):
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(num_key_value_heads=kv))
    port = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv),
                            device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return jax_model, port


@pytest.fixture(scope="module", params=["mha", "gqa"])
def twins(request):
    return _models(2 if request.param == "gqa" else None)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("cache_len,length", [(0, 13), (8, 7), (6, 9)],
                         ids=["start", "aligned", "unaligned"])
def test_prefill_ext_matches_jax_adapter(twins, quant, cache_len, length):
    jax_model, port = twins
    jad, tad = JaxAdapter(jax_model), LlamaServingAdapter(port)
    cfg = port.config
    hkv, d = cfg.num_key_value_heads, cfg.hidden_size // \
        cfg.num_attention_heads
    rng = np.random.RandomState(cache_len + 17 * quant)
    jk, tk, jv, tv = [], [], [], []
    for _ in range(cfg.num_hidden_layers):
        # random cached pages: the prefix a fork or an earlier chunk left
        a, b = _pages(rng, hkv, 8, 4, d, quant)
        jk.append(a)
        tk.append(b)
        a, b = _pages(rng, hkv, 8, 4, d, quant)
        jv.append(a)
        tv.append(b)
    ids = rng.randint(1, 128, 16).astype(np.int64)
    table = np.array([3, 0, 5, 1, 7, 2], np.int32)   # capacity 24
    jlog, jk2, jv2 = jax.jit(jad.prefill_ext)(
        jad.weights, tuple(jk), tuple(jv), jnp.asarray(ids), length,
        cache_len, jnp.asarray(table))
    _build.reset_launch_counts()
    tlog = tad.prefill_ext(tk, tv, torch.from_numpy(ids),
                           torch.tensor(length, dtype=torch.int32),
                           torch.tensor(cache_len, dtype=torch.int32),
                           torch.from_numpy(table))
    assert set(launch_counts().values()) == {0}
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS_TOL)
    for jside, tside in ((jk2, tk), (jv2, tv)):
        for je, te in zip(jside, tside):
            if not quant:
                np.testing.assert_allclose(te.numpy()[:, :-1],
                                           np.asarray(je), **LOGITS_TOL)
                continue
            diff = np.abs(te[0].numpy()[:, :-1].astype(np.int32)
                          - np.asarray(je[0]).astype(np.int32))
            assert diff.max() <= 1
            np.testing.assert_allclose(te[1].numpy()[:, :-1],
                                       np.asarray(je[1]), rtol=1e-5, atol=0)


# ---------------------------------------------------------------- engine
def _mixed_workload(n_req=32):
    """The JAX package's acceptance workload (tests/test_serving.py:117):
    prompt + new = 16 tokens, 8 up front, the rest mid-flight."""
    rng = np.random.default_rng(42)
    lens = [int(n) for n in rng.choice([4, 7, 10, 13], n_req)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [16 - n for n in lens]
    arrivals = sorted([0] * 8 + rng.integers(1, 20, n_req - 8).tolist())
    return prompts, max_new, arrivals


PREFIX_CFG = dict(max_batch_slots=4, max_model_len=32, page_size=4,
                  num_blocks=96, prefill_buckets=[8, 16, 32],
                  enable_prefix_cache=True, prefill_chunk_tokens=8,
                  max_prefill_chunks_per_step=1, seed=3)


@pytest.fixture(scope="module")
def model(twins):
    return twins[1]


@pytest.fixture(scope="module")
def prefix_engine(model):
    """The JAX ``prefix_engine`` configuration; drains between tests, so
    only counters and retained cache blocks persist."""
    return Engine(model, EngineConfig(**PREFIX_CFG))


def _oracle(model, prompt, max_new):
    out = model.generate(torch.tensor([prompt]), max_new_tokens=max_new)
    return out[0, len(prompt):].tolist()


def _drain(engine):
    done, guard = {}, 0
    while engine.has_unfinished():
        for out in engine.step():
            done[out.request_id] = out
        guard += 1
        assert guard < 300, "engine failed to drain"
    return done


def _serve_staggered(engine, prompts, max_new, arrivals):
    done, pending, submitted, step = {}, list(zip(prompts, max_new,
                                                  arrivals)), [], 0
    while pending or engine.has_unfinished():
        while pending and pending[0][2] <= step:
            p, k, _ = pending.pop(0)
            submitted.append(engine.add_request(
                p, SamplingParams(max_new_tokens=k)))
        for out in engine.step():
            done[out.request_id] = out
        step += 1
        assert step < 500, "engine failed to drain"
    return [done[r.request_id].token_ids for r in submitted]


def test_mixed_workload_parity_two_passes(twins, prefix_engine):
    jax_model, model = twins
    engine = prefix_engine
    prompts, max_new, arrivals = _mixed_workload()
    refs = [_oracle(model, p, k) for p, k in zip(prompts, max_new)]
    # the JAX engine's tokens on the same weights (analysis gate off)
    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(
        **PREFIX_CFG))
    jout = jeng.generate(prompts, [jax_serving.SamplingParams(
        max_new_tokens=k) for k in max_new])
    assert [o.token_ids for o in jout] == refs
    _build.reset_launch_counts()
    for _pass in (1, 2):
        assert _serve_staggered(engine, prompts, max_new, arrivals) == refs
    m = engine.metrics
    assert m.prefix_hit_tokens > 0
    assert m.cow_copies >= 1
    assert m.prefill_chunks > 0
    # the compile probes: one decode program, at most one program per
    # bucket per prefill family, one copy-on-write program
    assert m.decode_compiles == 1
    assert m.prefill_compiles <= 3
    assert m.prefill_ext_compiles <= 3
    assert m.cow_compiles <= 1
    # CPU tensors take the plain versions: no kernel counted
    assert set(launch_counts().values()) == {0}
    bm = engine.block_manager
    assert bm.num_used == engine.prefix_cache.reclaimable_blocks()


def test_cache_disabled_engine_matches_enabled(model, prefix_engine):
    prompts = [[21, 22, 23, 24], [31, 32, 33], [41, 42, 43, 44, 45]]
    params = SamplingParams(max_new_tokens=6)
    plain = Engine(model, EngineConfig(max_batch_slots=4, max_model_len=32,
                                       page_size=4, seed=3))
    a = plain.generate(prompts, params)
    b = prefix_engine.generate(prompts, params)    # miss pass
    c = prefix_engine.generate(prompts, params)    # hit pass
    for x, y, z in zip(a, b, c):
        assert x.token_ids == y.token_ids == z.token_ids


def test_shared_system_prompt_cuts_prefill_compute(model, prefix_engine):
    engine = prefix_engine
    sys_prefix = list(range(60, 76))              # 16 tokens, 4 blocks
    params = SamplingParams(max_new_tokens=4)
    engine.generate([sys_prefix + [90, 91, 92, 93]], params)
    m = engine.metrics
    tails = [[100 + 4 * i + j for j in range(4)] for i in range(6)]
    prompts = [sys_prefix + t for t in tails]
    computed0, hit0 = m.prefill_tokens, m.prefix_hit_tokens
    outs = engine.generate(prompts, params)
    total = sum(len(p) for p in prompts)
    shared = 16 * len(prompts)
    assert m.prefix_hit_tokens - hit0 == shared
    assert m.prefill_tokens - computed0 == total - shared
    for out, p in zip(outs[:2], prompts[:2]):
        assert out.token_ids == _oracle(model, p, 4)


def test_chunked_prefill_interleaves_decode(model, prefix_engine):
    engine = prefix_engine
    rng = np.random.default_rng(7)
    short_p = [int(t) for t in rng.integers(1, 128, 4)]
    long_p = [int(t) for t in rng.integers(1, 128, 13)]
    chunks0 = engine.metrics.prefill_chunks
    short = engine.add_request(short_p, SamplingParams(max_new_tokens=12))
    engine.step()   # short admitted, prefilled, first decode
    n_before = len(short.output_token_ids)
    long = engine.add_request(long_p, SamplingParams(max_new_tokens=3))
    engine.step()   # long chunk 1/2; short decodes
    assert long.state is RequestState.PREFILLING
    assert long.output_token_ids == []
    assert len(short.output_token_ids) == n_before + 1
    engine.step()   # long chunk 2/2 (final) + decode
    assert long.state in (RequestState.RUNNING, RequestState.FINISHED)
    assert len(long.output_token_ids) >= 1
    assert len(short.output_token_ids) == n_before + 2
    assert engine.metrics.prefill_chunks == chunks0 + 2
    done = _drain(engine)
    assert done[short.request_id].token_ids == _oracle(model, short_p, 12)
    assert done[long.request_id].token_ids == _oracle(model, long_p, 3)


def test_cow_divergence_never_mutates_shared_block(model, prefix_engine):
    engine = prefix_engine
    prompt = [70, 71, 72, 73, 74, 75, 76, 77]      # 2 full blocks
    params = SamplingParams(max_new_tokens=5)
    first = engine.generate([prompt], params)[0]
    match = engine.prefix_cache.lookup(prompt, limit=len(prompt))
    assert match is not None and match.num_shared == 2
    b1 = match.shared_blocks[1]
    snap = [(engine.pool.k[li][:, b1].clone(), engine.pool.v[li][:, b1]
             .clone()) for li in range(engine.adapter.num_layers)]
    cow0 = engine.metrics.cow_copies
    second = engine.generate([prompt], params)[0]
    assert engine.metrics.cow_copies == cow0 + 1
    assert second.token_ids == first.token_ids == _oracle(model, prompt, 5)
    for li, (ks, vs) in enumerate(snap):
        assert torch.equal(engine.pool.k[li][:, b1], ks), li
        assert torch.equal(engine.pool.v[li][:, b1], vs), li


def test_reclaimable_cached_blocks_are_not_pressure(prefix_engine):
    engine = prefix_engine
    engine.generate([[80, 81, 82, 83, 84]], SamplingParams(max_new_tokens=2))
    bm = engine.block_manager
    assert bm.num_used > 0          # retained cache blocks
    h = engine.health()
    assert h["kv_reclaimable_blocks"] == bm.num_used
    assert h["kv_active_utilization"] == 0.0
    assert h["kv_utilization"] > 0.0
    assert h["prefix_cache_blocks"] == len(engine.prefix_cache)
    assert h["prefix_cache_digests"] == list(
        engine.prefix_cache.chain_digests())
    assert engine.metrics.prefix_cache_blocks == len(engine.prefix_cache)
    engine.config.kv_shed_threshold = 0.01
    try:
        ok = engine.add_request([1, 2], SamplingParams(max_new_tokens=2))
        assert "overloaded" not in engine.health()["flags"]
        assert _drain(engine)[ok.request_id].finish_reason == "length"
    finally:
        engine.config.kv_shed_threshold = None


def test_config_validation_and_adapter_gate(model):
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        EngineConfig(max_model_len=32, prefill_chunk_tokens=0)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        EngineConfig(max_model_len=32, prefill_chunk_tokens=64)
    with pytest.raises(ValueError, match="prefix_cache_blocks"):
        EngineConfig(enable_prefix_cache=True, prefix_cache_blocks=0)
    with pytest.raises(ValueError, match="max_prefill_chunks"):
        EngineConfig(max_prefill_chunks_per_step=0)

    class MinimalAdapter:
        """The adapter surface WITHOUT prefill_ext: fine for plain
        serving, refused when the flags need continuations."""
        num_layers = num_kv_heads = 1
        head_dim, vocab_size = 4, 8
        device, dtype = "cpu", torch.float32

        def prefill(self, *a):
            raise NotImplementedError

        def decode(self, *a):
            raise NotImplementedError

    geo = dict(max_batch_slots=1, max_model_len=16, page_size=4)
    Engine(MinimalAdapter(), EngineConfig(**geo))
    with pytest.raises(TypeError, match="prefill_ext") as ei:
        Engine(MinimalAdapter(), EngineConfig(**geo,
                                              enable_prefix_cache=True))
    assert "enable_prefix_cache" in str(ei.value)
    with pytest.raises(TypeError, match="prefill_chunk_tokens=4"):
        Engine(MinimalAdapter(), EngineConfig(**geo, prefill_chunk_tokens=4))


@pytest.mark.parametrize("pool", [None, "int8"], ids=["float", "int8"])
def test_prefix_engine_greedy_matches_jax_engine_under_pressure(twins, pool):
    # a starved pool: admissions reclaim cached blocks and running
    # requests reclaim or preempt; chunks of 4 over a shared prefix
    jax_model, port = twins
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 128, 9).tolist()
    prompts = [shared + rng.randint(1, 128, n).tolist()
               for n in (1, 4, 6, 3, 2, 5)]
    max_new = [24 - len(p) for p in prompts]
    geo = dict(max_batch_slots=3, max_model_len=32, page_size=4,
               num_blocks=14, prefill_buckets=[4, 8, 16, 32],
               enable_prefix_cache=True, prefill_chunk_tokens=4,
               max_prefill_chunks_per_step=2, kv_cache_dtype=pool)
    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(**geo))
    ref = [o.token_ids for o in jeng.generate(
        prompts, [jax_serving.SamplingParams(max_new_tokens=k)
                  for k in max_new])]
    eng = Engine(port, EngineConfig(**geo))
    for _ in range(2):
        out = eng.generate(prompts, [SamplingParams(max_new_tokens=k)
                                     for k in max_new])
        assert [o.token_ids for o in out] == ref
    m = eng.metrics
    assert m.prefix_hits > 0 and m.prefix_evictions > 0
    assert m.prefill_chunks > 0
    assert m.prefill_ext_compiles <= 4 and m.cow_compiles <= 1
    assert eng.block_manager.num_used == len(eng.prefix_cache)


# -------------------------------------------------------------- programs
class NoHostSync(TorchDispatchMode):
    """Fails on any op that reads a device value on the host, takes a
    data-dependent shape or brings host data into the program (as the
    guard of ``tests/test_torch_programs.py``)."""

    FORBIDDEN = {
        torch.ops.aten._local_scalar_dense.default,
        torch.ops.aten.nonzero.default,
        torch.ops.aten.masked_select.default,
        torch.ops.aten.lift_fresh.default,
        torch.ops.aten.item.default,
        torch.ops.aten.is_nonzero.default,
    }

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN:
            raise AssertionError(f"host sync in a program: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_continuation_and_cow_programs_are_sync_free(model, kv_cache_dtype):
    eng = Engine(model, EngineConfig(**dict(PREFIX_CFG,
                                            kv_cache_dtype=kv_cache_dtype)))
    prompt = list(range(3, 15))                   # 12 tokens: 3 blocks
    eng.generate([prompt], SamplingParams(max_new_tokens=2))
    eng.generate([prompt], SamplingParams(max_new_tokens=2, do_sample=True))
    assert eng.metrics.cow_copies == 1
    ext = eng._prefill_ext_programs[8]
    eng._prefill_ext_buffers.stage()
    with NoHostSync():
        tok, logits = ext.fn()
        eng._cow_prog.fn()
    assert tok.shape == (1,) and logits.shape == (model.config.vocab_size,)


def test_programs_are_built_over_inert_inputs(model):
    # the continuation program's build runs its function once; over
    # zeroed inputs (a chunk of length 0 at cache_len 0) it writes no
    # page, and the copy program's build copies the sink page onto itself
    eng = Engine(model, EngineConfig(**PREFIX_CFG))
    build, seen = eng._program, []

    def checked(fn, generator):
        if generator is None:
            seen.append(("cow", eng._cow_buffers.device.tolist()))
        else:
            seen.append(("ext", bool(eng._prefill_ext_buffers.device.any())
                         or bool(eng._prefill_buffers.device.any())))
        return build(fn, generator)

    eng._program = checked
    before = [t.clone() for t in eng.pool.k + eng.pool.v]
    eng._prefill_ext_program(8)
    eng._cow_program()
    after = eng.pool.k + eng.pool.v
    assert all(torch.equal(a[:, :-1], b[:, :-1])
               for a, b in zip(before, after))
    sink = eng.pool.sink_page
    assert seen == [("ext", False), ("cow", [sink, sink])]
    assert eng.metrics.prefill_ext_compiles == 1
    assert eng.metrics.cow_compiles == 1


def test_copy_block_copies_every_layer_and_scale_plane():
    from paddle_tpu_torch.serving import KVPool

    pool = KVPool(2, 2, 5, 4, 8, device="cpu", quant_dtype="int8")
    for entry in pool.k + pool.v:
        for t in entry:
            t.copy_(torch.randn(t.shape).to(t.dtype) if t.is_floating_point()
                    else torch.randint(-127, 128, t.shape, dtype=t.dtype))
    before = [t.clone() for e in pool.k + pool.v for t in e]
    pool.copy_block(torch.tensor(1), torch.tensor(3))
    for b, e in zip(before, [t for e in pool.k + pool.v for t in e]):
        assert torch.equal(e[:, 3], b[:, 1])
        keep = [i for i in range(e.shape[1]) if i != 3]
        assert torch.equal(e[:, keep], b[:, keep])


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_chunked_prefill_is_bitwise_one_shot_on_cpu_f32(kv):
    # JAX's contract for chunked prefill is bit-parity with one shot in
    # f32; on the CPU the port keeps it: two continuation chunks give the
    # one-shot prefill's logits and live pages bit for bit (the sink page,
    # where each writes its padded rows, left out). One thread, so the
    # products reduce in one order.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv),
                             device="cpu", seed=0)
        ad = LlamaServingAdapter(m)
        ids = torch.from_numpy(
            np.random.RandomState(1).randint(1, 128, 13).astype(np.int64))
        table = torch.arange(8, dtype=torch.int32)

        def pool():
            from paddle_tpu_torch.serving import KVPool

            return KVPool(ad.num_layers, ad.num_kv_heads, 8, 4, ad.head_dim,
                          device="cpu")

        one, chunked = pool(), pool()
        padded = torch.zeros(16, dtype=torch.long)
        padded[:13] = ids
        want = ad.prefill(one.k, one.v, padded, 13, table)
        first = torch.zeros(8, dtype=torch.long)
        first[:8] = ids[:8]
        ad.prefill_ext(chunked.k, chunked.v, first, 8, 0, table)
        rest = torch.zeros(8, dtype=torch.long)
        rest[:5] = ids[8:]
        got = ad.prefill_ext(chunked.k, chunked.v, rest, 5, 8, table)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got, want)
    for a, b in zip(one.k + one.v, chunked.k + chunked.v):
        assert torch.equal(a[:, :-1], b[:, :-1])
