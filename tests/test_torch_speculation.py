"""The port's speculative decoding on the CPU, against the JAX package on
the same numpy inputs and weights.

* ``serving.speculation``: ``propose`` and ``accept_length`` give JAX's
  results on seeded random histories and on the cases of JAX's
  ``test_drafter_unit`` (``tests/test_serving.py:852``).
* The batched ``kernels.paged_prefill_ref`` (the verify window's plain
  attention) against JAX's ``_gather_context_batch`` and the masked
  ``_sdpa`` within rtol 1e-4 / atol 1e-5 (f32 products whose last bits
  differ between the frameworks), float and int8 pages, MHA and GQA,
  inactive slots and padded rows; its row 0 equal bit for bit to the
  decode step's plain attention (``paged_attention_ref``).
* ``adapter.verify`` against the JAX adapter's ``verify`` on twin weights
  and the same pool: logits of the valid rows within rtol 1e-4 / atol
  1e-4, the window's pages written at the valid positions (float within
  the same tolerance, int8 within one quantization step, scales rtol
  1e-5) and every other page untouched.
* The engine with ``speculate_tokens=3`` in the JAX ``spec_engine``
  configuration (``tests/test_serving.py:834``; reference engines as JAX
  builds them by default, the analysis gate off): greedy outputs equal
  the JAX speculative engine's, the spec-disabled engine's and the port's
  ``generate``; on all-greedy runs the JAX engine's ``verify_steps``,
  ``spec_proposed`` and ``spec_accepted`` exactly; forced accept, reject
  and EOS inside an accepted draft; TTL and preemption mid-speculation;
  draft headroom reclaimed before preemption and before shedding;
  ``health()``; validation and the adapter gate; no kernel launch on CPU
  tensors, and ``decode_kernel="xla"`` counting the plain window
  attention once per layer per verify step; the prefix cache beside
  speculation with the cached pages untouched; the verify program free
  of host syncs and built over inputs that write no page.
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
from paddle_tpu.serving import speculation as jax_speculation
from paddle_tpu.serving.adapter import LlamaServingAdapter as JaxAdapter
from paddle_tpu.serving.adapter import _gather_context_batch
from paddle_tpu_torch.kernels import _build, launch_counts
from paddle_tpu_torch.kernels import paged_prefill as ppf
from paddle_tpu_torch.kernels.paged_attention import paged_attention_ref
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.serving import (
    Engine,
    EngineConfig,
    EngineOverloadedError,
    KVPool,
    SamplingParams,
    speculation,
)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.adapter import LlamaServingAdapter

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
SPEC_CFG = dict(max_batch_slots=4, max_model_len=32, page_size=4,
                num_blocks=48, prefill_buckets=[16, 32], speculate_tokens=3,
                seed=3)
IMPLS = {"port": speculation, "jax": jax_speculation}


# ------------------------------------------------------------- drafter
@pytest.mark.parametrize("impl", ["port", "jax"])
def test_drafter_unit(impl):
    propose, accept_length = IMPLS[impl].propose, IMPLS[impl].accept_length
    hist = [1, 2, 3, 4] * 4
    assert propose(hist, 6) == [1, 2, 3, 4, 1, 2]
    hist = [9, 5, 6, 1, 9, 5, 6, 2, 9, 5]
    assert propose(hist, 3, max_ngram=2) == [6]
    assert propose([1, 2, 3, 4, 5], 4) == []
    assert propose([1, 2] * 4, 0) == []
    assert propose([7, 8, 9, 7, 8], 4, max_ngram=2) == [9, 7, 8]
    assert accept_length([5, 6, 7], [5, 6, 7]) == 3
    assert accept_length([5, 9, 7], [5, 6, 7]) == 1
    assert accept_length([9, 6, 7], [5, 6, 7]) == 0
    assert accept_length([], [5, 6]) == 0
    assert IMPLS[impl].DEFAULT_LOOKBACK == 512


@pytest.mark.parametrize("seed", range(4))
def test_drafter_matches_jax_on_random_histories(seed):
    rng = np.random.RandomState(seed)
    for _ in range(60):
        # a small vocabulary, so n-grams repeat
        hist = rng.randint(0, 1 + rng.randint(2, 6),
                           rng.randint(0, 40)).tolist()
        k, n = int(rng.randint(0, 7)), int(rng.randint(1, 5))
        lookback = int(rng.choice([3, 8, 16, 512]))
        got = speculation.propose(hist, k, max_ngram=n, lookback=lookback)
        want = jax_speculation.propose(hist, k, max_ngram=n,
                                       lookback=lookback)
        assert got == want, (hist, k, n, lookback)
        targets = rng.randint(0, 4, len(got) + 1).tolist()
        assert (speculation.accept_length(got, targets)
                == jax_speculation.accept_length(got, targets))


# ------------------------------------------------ batched paged_prefill
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
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)],
                         ids=["mha", "gqa", "gqa4"])
def test_batched_paged_prefill_ref_matches_jax_masked_form(quant, hq, hkv):
    rng = np.random.RandomState(hq + 5 * hkv + quant)
    page, d, s, n_pages = 4, 16, 4, 12
    jk, tk = _pages(rng, hkv, n_pages, page, d, quant)
    jv, tv = _pages(rng, hkv, n_pages, page, d, quant)
    # five slots: mid-table, at 0, a window reaching the table's last
    # position, an inactive slot (length 0) and one row of four valid
    tables = rng.randint(0, n_pages, (5, 4)).astype(np.int32)
    cache_len = np.array([6, 0, 12, 3, 9], np.int32)
    length = np.array([4, 2, 4, 0, 1], np.int32)
    q = rng.randn(5, s, hq, d).astype(np.float32)
    kc = _gather_context_batch(jk, jnp.asarray(tables))
    vc = _gather_context_batch(jv, jnp.asarray(tables))
    if hkv != hq:
        kc = jnp.repeat(kc, hq // hkv, axis=2)
        vc = jnp.repeat(vc, hq // hkv, axis=2)
    pos = cache_len[:, None] + np.arange(s)[None]
    keep = np.arange(tables.shape[1] * page)[None, None] <= pos[:, :, None]
    ref = np.asarray(jsdpa(jnp.asarray(q), kc, vc,
                           jnp.asarray(keep)[:, None]))
    args = (tk, tv, torch.from_numpy(tables), torch.from_numpy(cache_len),
            torch.from_numpy(length))
    out = ppf.paged_prefill_ref(torch.from_numpy(q), *args)
    assert out.shape == q.shape and bool(out.isfinite().all())
    for i, n in enumerate(length):
        np.testing.assert_allclose(out[i, :n].numpy(), ref[i, :n],
                                   **ATTN_TOL)
    # each slot alone through the single-sequence form
    for i in range(5):
        one = ppf.paged_prefill_ref(
            torch.from_numpy(q[i]), tk, tv, torch.from_numpy(tables[i]),
            torch.tensor(cache_len[i]), torch.tensor(length[i]))
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), **ATTN_TOL)
    # row 0 of a window is the decode step's plain attention, bit for bit
    dec = paged_attention_ref(torch.from_numpy(q[:, 0]), tk, tv,
                              torch.from_numpy(tables),
                              torch.from_numpy(cache_len + 1))
    assert torch.equal(out[:, 0], dec)
    # the wrapper takes the plain version for CPU tensors, uncounted
    _build.reset_launch_counts()
    got = ppf.paged_prefill(torch.from_numpy(q), *args)
    assert launch_counts()["paged_prefill"] == 0
    torch.testing.assert_close(got, out, rtol=0, atol=0)


def test_batched_paged_prefill_checks_its_slot_shapes():
    pages = torch.zeros(2, 5, 4, 16)
    q = torch.zeros(3, 2, 4, 16)
    table = torch.zeros(3, 4, dtype=torch.int32)
    lens = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots=3"):
        ppf.paged_prefill(q, pages, pages, table[:2], lens, lens)
    with pytest.raises(ValueError, match="cache_len and length"):
        ppf.paged_prefill(q, pages, pages, table, lens[:1], lens)
    with pytest.raises(ValueError, match=r"block_table must be \[P\]"):
        ppf.paged_prefill(q[0], pages, pages, table, lens[0], lens[0])


# --------------------------------------------------------- adapter verify
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
def test_verify_matches_jax_adapter(twins, quant):
    jax_model, port = twins
    jad, tad = JaxAdapter(jax_model), LlamaServingAdapter(port)
    cfg = port.config
    hkv = cfg.num_key_value_heads
    d = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.RandomState(11 + quant)
    n_pages, page = 16, 4
    jk, tk, jv, tv = [], [], [], []
    for _ in range(cfg.num_hidden_layers):
        a, b = _pages(rng, hkv, n_pages, page, d, quant)
        jk.append(a)
        tk.append(b)
        a, b = _pages(rng, hkv, n_pages, page, d, quant)
        jv.append(a)
        tv.append(b)
    before = [tuple(t.clone() for t in e) if quant else e.clone()
              for e in tk + tv]
    tables = rng.permutation(n_pages).reshape(4, 4).astype(np.int32)
    # slot 0 mid-table with a full draft, slot 1 at position 0 with one
    # draft token, slot 2 inactive, slot 3 a window cut by the table's
    # capacity (positions 14..17 of 16)
    tokens = rng.randint(1, 128, (4, 4)).astype(np.int64)
    positions = np.array([5, 0, 9, 14], np.int32)
    draft_lens = np.array([3, 1, 2, 3], np.int32)
    active = np.array([True, True, False, True])
    jlog, jk2, jv2 = jax.jit(jad.verify)(
        jad.weights, tuple(jk), tuple(jv), *map(jnp.asarray, (
            tokens, positions, draft_lens, tables, active)))
    _build.reset_launch_counts()
    tlog = tad.verify(tk, tv, *map(torch.from_numpy, (
        tokens, positions, draft_lens, tables, active)))
    assert set(launch_counts().values()) == {0}
    assert tlog.shape == (4, 4, cfg.vocab_size)
    capacity = tables.shape[1] * page
    valid = (active[:, None] & (np.arange(4)[None] <= draft_lens[:, None])
             & (positions[:, None] + np.arange(4)[None] < capacity))
    jlog = np.asarray(jlog)
    for s in range(4):
        # a window row is read only where its token is real
        rows = np.arange(4) <= draft_lens[s]
        if active[s]:
            np.testing.assert_allclose(tlog[s, rows].numpy(), jlog[s, rows],
                                       **LOGITS_TOL)
    written = np.zeros((n_pages, page), bool)
    for s, j in zip(*np.nonzero(valid)):
        pos = positions[s] + j
        written[tables[s, pos // page], pos % page] = True
    assert written.sum() == valid.sum() == 8
    for jside, tside, old in ((jk2, tk, before[:len(tk)]),
                              (jv2, tv, before[len(tk):])):
        for je, te, ob in zip(jside, tside, old):
            if not quant:
                live = te[:, :-1].numpy()
                np.testing.assert_allclose(live[:, written],
                                           np.asarray(je)[:, written],
                                           **LOGITS_TOL)
                assert np.array_equal(live[:, ~written],
                                      ob[:, :-1].numpy()[:, ~written])
                continue
            q8, sc = te[0][:, :-1].numpy(), te[1][:, :-1].numpy()
            diff = np.abs(q8[:, written].astype(np.int32)
                          - np.asarray(je[0])[:, written].astype(np.int32))
            assert diff.max() <= 1
            np.testing.assert_allclose(sc[:, written],
                                       np.asarray(je[1])[:, written],
                                       rtol=1e-5, atol=0)
            assert np.array_equal(q8[:, ~written],
                                  ob[0][:, :-1].numpy()[:, ~written])
            assert np.array_equal(sc[:, ~written],
                                  ob[1][:, :-1].numpy()[:, ~written])


def test_verify_row_zero_is_the_decode_step_on_cpu_f32():
    # the window's plain attention reduces each row as the decode step's
    # does, and the first layer's K/V rows (from the embeddings alone) are
    # the decode step's bit for bit; the logits agree within an ulp-scale
    # bound and in their argmax (the projections take [slots * (K+1),
    # hid] rows against [slots, hid], which the CPU's GEMM may reduce in
    # another order)
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device="cpu", seed=0)
    ad = LlamaServingAdapter(model)
    rng = np.random.RandomState(0)

    def pool():
        p = KVPool(ad.num_layers, ad.num_kv_heads, 40, 4, ad.head_dim,
                   device="cpu")
        g = torch.Generator().manual_seed(1)
        for t in p.k + p.v:
            t.copy_(torch.randn(t.shape, generator=g))
        return p

    dp, vp_ = pool(), pool()
    tables = torch.from_numpy(rng.permutation(40)[:32].reshape(4, 8)
                              .astype(np.int32))
    tokens = torch.from_numpy(rng.randint(1, 128, (4, 4)))
    positions = torch.tensor([5, 9, 0, 27], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    want = ad.decode(dp.k, dp.v, tokens[:, 0], positions, tables, active)
    got = ad.verify(vp_.k, vp_.v, tokens, positions,
                    torch.tensor([3, 0, 2, 3], dtype=torch.int32), tables,
                    active)
    torch.testing.assert_close(got[:3, 0], want[:3], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[:3, 0].argmax(-1), want[:3].argmax(-1))
    for a, b in ((dp.k[0], vp_.k[0]), (dp.v[0], vp_.v[0])):
        for s in range(3):
            p = int(positions[s])
            phys = tables[s, p // 4]
            assert torch.equal(a[:, phys, p % 4], b[:, phys, p % 4])


# ----------------------------------------------------------------- engine
def _mixed_workload(n_req=32):
    """The JAX package's acceptance workload (tests/test_serving.py:117)."""
    rng = np.random.default_rng(42)
    lens = [int(n) for n in rng.choice([4, 7, 10, 13], n_req)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [16 - n for n in lens]
    return prompts, max_new


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


@pytest.fixture(scope="module")
def model(twins):
    return twins[1]


@pytest.fixture(scope="module")
def spec_engine(model):
    """The JAX ``spec_engine`` configuration; drains between tests."""
    return Engine(model, EngineConfig(**SPEC_CFG))


def test_mixed_workload_parity_with_jax_and_generate(twins, spec_engine):
    jax_model, model = twins
    prompts, max_new = _mixed_workload()

    def params(cls):
        return [cls(max_new_tokens=k, do_sample=(i % 4 == 3),
                    temperature=0.8, top_k=20)
                for i, k in enumerate(max_new)]

    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(
        **SPEC_CFG))
    jout = jeng.generate(prompts, params(jax_serving.SamplingParams))
    plain = Engine(model, EngineConfig(**dict(SPEC_CFG,
                                              speculate_tokens=None)))
    pout = plain.generate(prompts, params(SamplingParams))
    _build.reset_launch_counts()
    out = spec_engine.generate(prompts, params(SamplingParams))
    assert set(launch_counts().values()) == {0}
    for o, j, p, prompt, k, i in zip(out, jout, pout, prompts, max_new,
                                     range(len(prompts))):
        if i % 4 == 3:
            assert len(o.token_ids) == k
            assert all(0 <= t < 128 for t in o.token_ids)
            continue
        assert o.token_ids == j.token_ids == p.token_ids, prompt
        assert o.token_ids == _oracle(model, prompt, k), prompt
    m = spec_engine.metrics
    assert m.verify_compiles == 1
    assert m.decode_compiles <= 2 and m.prefill_compiles <= 2
    assert m.spec_proposed > 0 and m.verify_steps > 0
    assert spec_engine.block_manager.num_used == 0


@pytest.mark.parametrize("workload", ["mixed", "repetitive"])
def test_all_greedy_counters_equal_jax_engine(twins, workload):
    jax_model, model = twins
    if workload == "mixed":
        prompts, max_new = _mixed_workload()
    else:
        # bench.py's speculative workload, cut to the tiny model: prompts
        # of 12 copies of one token
        prompts = [[int(t)] * 12
                   for t in np.random.RandomState(3).randint(1, 128, 8)]
        max_new = [16] * len(prompts)
    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(
        **SPEC_CFG))
    jout = jeng.generate(prompts, [jax_serving.SamplingParams(
        max_new_tokens=k) for k in max_new])
    eng = Engine(model, EngineConfig(**SPEC_CFG))
    out = eng.generate(prompts, [SamplingParams(max_new_tokens=k)
                                 for k in max_new])
    assert [o.token_ids for o in out] == [o.token_ids for o in jout]
    jm, m = jeng.metrics, eng.metrics
    assert (m.verify_steps, m.spec_proposed, m.spec_accepted) == (
        jm.verify_steps, jm.spec_proposed, jm.spec_accepted)
    assert m.decode_steps == jm.decode_steps
    assert m.spec_accept_hist() == jm.spec_accept_hist()
    assert m.spec_accepted > 0


def test_forced_accept_reject_and_eos_mid_draft(model, spec_engine,
                                                monkeypatch):
    prompt = [3, 17, 42, 99]
    ref = _oracle(model, prompt, 12)

    def feeding(history, k, **kw):
        done = [int(t) for t in history[len(prompt):]]
        if history[:len(prompt)] == prompt and ref[:len(done)] == done:
            return ref[len(done):len(done) + k]
        return []

    monkeypatch.setattr(engine_mod.speculation, "propose", feeding)
    m = spec_engine.metrics
    v0, a0 = m.verify_steps, m.spec_accepted
    out = spec_engine.generate([prompt], SamplingParams(max_new_tokens=12))[0]
    assert out.token_ids == ref
    assert m.verify_steps - v0 <= 5
    assert m.spec_accepted - a0 >= 8
    # EOS inside an accepted draft window: the first token past the first
    # that is new to the output stops it exactly where plain decode would
    stop = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    out = spec_engine.generate(
        [prompt], SamplingParams(max_new_tokens=12, eos_token_id=ref[stop])
    )[0]
    assert out.token_ids == ref[:stop + 1]
    assert out.finish_reason == "stop"

    def wrong(history, k, **kw):
        done = [int(t) for t in history[len(prompt):]]
        if history[:len(prompt)] == prompt and ref[:len(done)] == done:
            return [(t + 1) % 128 for t in ref[len(done):len(done) + k]]
        return []

    monkeypatch.setattr(engine_mod.speculation, "propose", wrong)
    a0, p0 = m.spec_accepted, m.spec_proposed
    out = spec_engine.generate([prompt], SamplingParams(max_new_tokens=12))[0]
    assert out.token_ids == ref
    assert m.spec_accepted == a0
    assert m.spec_proposed > p0
    assert spec_engine.block_manager.num_used == 0


def test_ttl_and_preemption_mid_spec(model, spec_engine):
    running = spec_engine.add_request([6, 7, 6, 7],
                                      SamplingParams(max_new_tokens=12))
    spec_engine.step()
    running.deadline = 0.0
    out = _drain(spec_engine)
    assert out[running.request_id].finish_reason == "timeout"
    assert spec_engine.block_manager.num_used == 0

    engine = Engine(model, EngineConfig(**dict(
        SPEC_CFG, num_blocks=10, prefill_buckets=[32])))
    rng = np.random.default_rng(7)
    lens = [int(n) for n in rng.choice([4, 7, 10], 6)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [16 - n for n in lens]
    outs = engine.generate(prompts, [SamplingParams(max_new_tokens=k)
                                     for k in max_new])
    assert engine.metrics.preemptions >= 1
    for o, p, k in zip(outs, prompts, max_new):
        assert o.token_ids == _oracle(model, p, k)
    assert engine.block_manager.num_used == 0


def test_headroom_is_reclaimable_and_reclaimed_first(model):
    # 8 blocks of 4; two greedy requests of 6 prompt tokens each hold 2
    # blocks and grab one block of draft headroom (K = 3 past position 6)
    eng = Engine(model, EngineConfig(**dict(SPEC_CFG, num_blocks=8)))
    bm = eng.block_manager
    a = eng.add_request([5, 6, 5, 6, 5, 6], SamplingParams(max_new_tokens=20))
    b = eng.add_request([7, 8, 7, 8, 7, 8], SamplingParams(max_new_tokens=20))
    eng._admit([])
    eng._prefill_chunks([])
    eng._ensure_capacity()
    assert [len(r.block_ids) for r in (a, b)] == [3, 3]
    assert eng._spec_headroom(a) == eng._spec_headroom(b) == 1
    h = eng.health()
    assert h["kv_reclaimable_blocks"] == 2
    assert h["kv_utilization"] == 6 / 8
    assert h["kv_active_utilization"] == 4 / 8
    # shedding reads active pressure: at a threshold between the active
    # and the raw utilization an admission is not shed
    eng.config.kv_shed_threshold = 0.6
    late = eng.add_request(list(range(1, 15)),
                           SamplingParams(max_new_tokens=2))
    eng.config.kv_shed_threshold = 0.4
    with pytest.raises(EngineOverloadedError):
        eng.add_request([1, 2], SamplingParams(max_new_tokens=2))
    eng.config.kv_shed_threshold = None
    # the 14-token prompt needs 4 blocks and 2 are free: admission takes
    # the headroom back instead of waiting
    eng._admit([])
    assert late.slot is not None and bm.num_free == 0
    assert eng._spec_headroom(a) == eng._spec_headroom(b) == 0
    # with the pool full, running growth reclaims headroom before it
    # preempts: b's next write needs a third block, a holds one spare
    eng._release(late)
    a.block_ids += bm.allocate(1)
    filler = bm.allocate(bm.num_free)
    b.num_cached = 8
    eng._ensure_capacity()
    assert eng.metrics.preemptions == 0
    assert len(a.block_ids) == 2 and len(b.block_ids) == 3
    assert bm.num_free == 0
    bm.free(filler)


def test_health_reports_the_accept_rate(spec_engine):
    # its own greedy repetitive traffic (12 copies of one token): drafts
    # are proposed whatever ran on this engine before, or nothing did
    prompts = [[int(t)] * 12
               for t in np.random.RandomState(5).randint(1, 128, 4)]
    spec_engine.generate(prompts, [SamplingParams(max_new_tokens=12)
                                   for _ in prompts])
    m = spec_engine.metrics
    assert m.spec_proposed > 0
    assert m.spec_accept_hist()
    rate = spec_engine.health()["spec_accept_rate"]
    assert rate is not None and 0.0 <= rate <= 1.0
    assert rate == m.spec_accepted / m.spec_proposed
    fresh = Engine(spec_engine.adapter.model, EngineConfig(**SPEC_CFG))
    assert fresh.health()["spec_accept_rate"] is None


def test_spec_config_validation_and_adapter_gate():
    with pytest.raises(ValueError, match="speculate_tokens"):
        EngineConfig(max_model_len=32, speculate_tokens=0)
    with pytest.raises(ValueError, match="speculate_tokens"):
        EngineConfig(max_model_len=32, speculate_tokens=32)
    with pytest.raises(ValueError, match="speculate_ngram"):
        EngineConfig(max_model_len=32, speculate_ngram=0)
    assert EngineConfig(max_model_len=32, speculate_tokens=31) \
        .speculate_tokens == 31

    class MinimalAdapter:
        """The adapter surface without ``verify``."""
        num_layers = num_kv_heads = 1
        head_dim, vocab_size = 4, 8
        device, dtype = "cpu", torch.float32

        def prefill(self, *a):
            raise NotImplementedError

        def decode(self, *a):
            raise NotImplementedError

    geo = dict(max_batch_slots=1, max_model_len=16, page_size=4)
    Engine(MinimalAdapter(), EngineConfig(**geo))
    with pytest.raises(TypeError, match="verify") as ei:
        Engine(MinimalAdapter(), EngineConfig(**geo, speculate_tokens=2))
    assert "speculate_tokens=2" in str(ei.value)


def test_xla_kernel_choice_counts_the_plain_window_per_layer(model):
    eng = Engine(model, EngineConfig(**dict(SPEC_CFG,
                                            decode_kernel="xla")))
    prompts = [[int(t)] * 12
               for t in np.random.RandomState(3).randint(1, 128, 4)]
    _build.reset_launch_counts()
    out = eng.generate(prompts, SamplingParams(max_new_tokens=16))
    m, counts = eng.metrics, launch_counts()
    L = model.config.num_hidden_layers
    assert m.verify_steps > 0
    assert counts["paged_prefill_ref"] == m.verify_steps * L
    assert counts["paged_attention_ref"] == m.decode_steps * L
    assert counts["paged_prefill"] == counts["kv_write"] == 0
    ref = Engine(model, EngineConfig(**SPEC_CFG)).generate(
        prompts, SamplingParams(max_new_tokens=16))
    assert [o.token_ids for o in out] == [o.token_ids for o in ref]


@pytest.mark.parametrize("pool", [None, "int8"], ids=["float", "int8"])
def test_prefix_cache_with_speculation_keeps_cached_pages(model, pool):
    eng = Engine(model, EngineConfig(**dict(
        SPEC_CFG, enable_prefix_cache=True, prefill_chunk_tokens=8,
        prefill_buckets=[8, 16, 32], kv_cache_dtype=pool)))
    system = [9, 8, 7, 6, 9, 8, 7, 6]                # 2 full blocks
    prompts = [system + [40 + i, 41 + i, 40 + i] for i in range(3)]
    params = SamplingParams(max_new_tokens=12)
    first = eng.generate(prompts[:1], params)[0]
    match = eng.prefix_cache.lookup(system, limit=len(system))
    assert match is not None and match.num_shared == 2

    def snap(blocks):
        return [tuple(t[:, b].clone() for t in (e if pool else (e,)))
                for e in eng.pool.k + eng.pool.v for b in blocks]

    before = snap(match.shared_blocks)
    p0 = eng.metrics.spec_proposed
    outs = eng.generate(prompts, params)
    assert eng.metrics.prefix_hit_tokens > 0
    assert eng.metrics.spec_proposed > p0
    assert outs[0].token_ids == first.token_ids
    if pool is None:
        for o, p in zip(outs, prompts):
            assert o.token_ids == _oracle(model, p, 12)
    for a, b in zip(before, snap(match.shared_blocks)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert eng.block_manager.num_used == len(eng.prefix_cache)


# -------------------------------------------------------------- program
class NoHostSync(TorchDispatchMode):
    """Fails on any op that reads a device value on the host, takes a
    data-dependent shape or brings host data into the program (the guard
    of ``tests/test_torch_programs.py``)."""

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
def test_verify_program_is_sync_free_and_built_inert(model, kv_cache_dtype):
    eng = Engine(model, EngineConfig(**dict(SPEC_CFG,
                                            kv_cache_dtype=kv_cache_dtype)))
    seen = []
    build = eng._program

    def checked(fn, generator):
        seen.append((generator, bool(eng._verify_buffers.device.any())))
        return build(fn, generator)

    eng._program = checked
    entries = eng.pool.k + eng.pool.v
    before = [tuple(t.clone() for t in e) if kv_cache_dtype else e.clone()
              for e in entries]
    prog = eng._verify_program()
    assert eng._verify_program() is prog
    assert seen == [(None, False)] and eng.metrics.verify_compiles == 1
    for a, b in zip(before, entries):
        for x, y in zip(*((a, b) if kv_cache_dtype else ((a,), (b,)))):
            assert torch.equal(x, y)
    eng._program = build
    eng.generate([[int(t)] * 12
                  for t in np.random.RandomState(3).randint(1, 128, 4)],
                 SamplingParams(max_new_tokens=8))
    assert eng.metrics.verify_steps > 0
    eng._verify_buffers.stage()
    with NoHostSync():
        tgt, logits = prog.fn()
    n, k = SPEC_CFG["max_batch_slots"], SPEC_CFG["speculate_tokens"]
    assert tgt.shape == (n, k + 1) and tgt.dtype == torch.int32
    assert logits.shape == (n, k + 1, model.config.vocab_size)
