"""The port's int8 KV cache against the JAX package's, on the CPU.

Same numpy inputs through both sides. The JAX paged kernel runs in
interpret mode (as ``tests/test_pallas_kernels.py`` runs it off-TPU)
beside its XLA reference; the port runs its plain versions, which its
wrappers take for CPU tensors (the CUDA kernel is held to them on the
card by ``chip_smoke.py``). Tolerances:

* ``quantize_tokens``: int8 values bit-identical, scales rtol 1e-6;
* the int8 page write (``kv_write_ref``) against JAX's ``update_pages``:
  bit-identical pools, at-capacity rows dropped;
* int8 attention: f32 rtol 1e-4, atol 1e-5 against ``paged_attention_xla``
  and the interpreted kernel, and within 0.05 of the float pool (the
  JAX ``test_int8_pool_tolerance`` contract); with float16 q, rtol and
  atol 2e-3 against ``paged_attention_xla`` (both sides compute in f32
  and round the output to float16, unit roundoff 2^-11);
* the int8 engine on converted weights: pools after prefill equal up to
  one int8 step in at most 0.1 % of the codes (K/V come from f32
  products whose last bits differ between the frameworks, and a value on
  a rounding boundary may round either way), scales rtol 1e-5, first
  decode logits within 1e-4, greedy tokens identical;
* the int8 pool stores a token in at most half the bytes of the f32 pool
  (the JAX ``test_int8_kv_halves_bytes_and_generates`` bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.kernels.pallas import paged_attention as jpa
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving.adapter import LlamaServingAdapter as JaxAdapter
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.kv_write import kv_write_ref
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.serving import (
    Engine,
    EngineConfig,
    KVPool,
    SamplingParams,
)
from paddle_tpu_torch.serving.adapter import LlamaServingAdapter

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
F16_ATTN_TOL = dict(rtol=2e-3, atol=2e-3)
POOL_TOL = dict(rtol=0.05, atol=0.05)


def _pool(seed=0, kvh=2, pages=10, bs=8, d=32):
    rng = np.random.RandomState(seed)
    kp = rng.randn(kvh, pages, bs, d).astype(np.float32)
    vp = rng.randn(kvh, pages, bs, d).astype(np.float32)
    return kp, vp


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _pair(j):
    return tuple(torch.from_numpy(np.array(x)) for x in j)


@pytest.mark.parametrize("shape,seed", [((2, 10, 8, 32), 0),
                                        ((5, 3, 20), 1), ((4, 16), 2)])
def test_quantize_tokens_bit_identical(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3.0
    x[0] = 0.0                      # an all-zero token: the 1e-8 floor
    x[-1, ..., 0] = 127.5 / 127.0   # half-way values in the last token
    q, s = pa.quantize_tokens(torch.from_numpy(x))
    jq, js = jpa.quantize_tokens(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert np.all(q.numpy()[0] == 0)


@pytest.mark.parametrize(
    "lens", [[5, 8], [0, 3], [7, 8]],
    ids=["partial_and_capacity_slot", "zero", "last_slot_and_at_capacity"],
)
def test_int8_update_pages_matches_jax(lens):
    # the port's page write (kv_write_ref, decode routing: slot b at its
    # length) against JAX's update_pages; the port's pool ends in the
    # sink page, which the comparison leaves out
    kp, vp = _pool(seed=6, kvh=2, pages=4, bs=4, d=16)
    rng = np.random.RandomState(7)
    kn = rng.randn(2, 2, 16).astype(np.float32)
    vn = rng.randn(2, 2, 16).astype(np.float32)
    bt = np.array([[0, 1], [2, 3]], np.int32)
    lens = np.array(lens, np.int32)   # a length of 8 is at capacity
    jk, jv = jpa.quantize_tokens(jnp.asarray(kp)), \
        jpa.quantize_tokens(jnp.asarray(vp))
    (jk2, jks2), (jv2, jvs2) = jpa.update_pages(
        jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(bt),
        jnp.asarray(lens))

    def with_sink(pair):
        return tuple(torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
                     for t in _pair(pair))

    pk, pv = with_sink(jk), with_sink(jv)
    kv_write_ref(pk, pv, *_t(kn, vn, bt, np.arange(2, dtype=np.int32),
                             lens, np.ones(2, bool)))
    for got, want in ((pk[0], jk2), (pk[1], jks2), (pv[0], jv2),
                      (pv[1], jvs2)):
        np.testing.assert_array_equal(got.numpy()[:, :-1], np.asarray(want))
    # an at-capacity row writes neither its page slot nor its scale
    if lens[1] == 8:
        np.testing.assert_array_equal(pk[0].numpy()[:, 2:-1],
                                      np.asarray(jk[0])[:, 2:])
        np.testing.assert_array_equal(pk[1].numpy()[:, 2:-1],
                                      np.asarray(jk[1])[:, 2:])


INT8_CASES = {
    # (q heads, kv heads, lengths): GQA group 2, then MHA with a zero row
    "gqa": (4, 2, [7, 20, 24]),
    "mha_zero": (2, 2, [0, 1, 13]),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_attention_matches_jax(case):
    hq, hkv, lens = INT8_CASES[case]
    kp, vp = _pool(seed=4, kvh=hkv)
    rng = np.random.RandomState(5)
    q = rng.randn(len(lens), hq, 32).astype(np.float32)
    bt = rng.randint(0, 10, (len(lens), 3)).astype(np.int32)
    lens = np.array(lens, np.int32)
    jk, jv = jpa.quantize_tokens(jnp.asarray(kp)), \
        jpa.quantize_tokens(jnp.asarray(vp))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens))
    xla = np.asarray(jpa.paged_attention_xla(*jargs))
    kern = np.asarray(jpa.paged_attention(*jargs))    # interpret mode
    pk, pv = pa.quantize_tokens(torch.from_numpy(kp)), \
        pa.quantize_tokens(torch.from_numpy(vp))
    tq, tbt, tlens = _t(q, bt, lens)
    reset_launch_counts()
    port = pa.paged_attention(tq, pk, pv, tbt, tlens).numpy()
    ref = pa.paged_attention_ref(tq, pk, pv, tbt, tlens).numpy()
    assert set(launch_counts().values()) == {0}       # CPU: plain version
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_allclose(port, xla, **ATTN_TOL)
    np.testing.assert_allclose(port, kern, **ATTN_TOL)
    assert np.all(port[lens == 0] == 0.0)
    # within the int8 tolerance of the float pool
    flt = pa.paged_attention_ref(tq, *_t(kp, vp), tbt, tlens).numpy()
    np.testing.assert_allclose(port, flt, **POOL_TOL)


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_attention_float16_q_matches_jax(case):
    # float16 q over the int8 pool (a float16 model's int8 serving): the
    # JAX package runs paged_attention_xla for such q, the port's card
    # its int8 kernel with a float16 q, held to this plain version
    hq, hkv, lens = INT8_CASES[case]
    kp, vp = _pool(seed=6, kvh=hkv)
    rng = np.random.RandomState(7)
    q = rng.randn(len(lens), hq, 32).astype(np.float16)
    bt = rng.randint(0, 10, (len(lens), 3)).astype(np.int32)
    lens = np.array(lens, np.int32)
    jk, jv = jpa.quantize_tokens(jnp.asarray(kp)), \
        jpa.quantize_tokens(jnp.asarray(vp))
    xla = np.asarray(jpa.paged_attention_xla(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens)))
    assert xla.dtype == np.float16
    pk, pv = _pair(jk), _pair(jv)      # the same int8 codes and scales
    tq, tbt, tlens = _t(q, bt, lens)
    reset_launch_counts()
    port = pa.paged_attention(tq, pk, pv, tbt, tlens)
    assert set(launch_counts().values()) == {0}
    assert port.dtype == torch.float16
    np.testing.assert_allclose(port.float().numpy(), xla.astype(np.float32),
                               **F16_ATTN_TOL)
    assert np.all(port.numpy()[lens == 0] == 0.0)


def test_int8_unwritten_slots_read_as_zero():
    # a zeroed pool (scales 0) dequantizes to exact zeros: attention
    # over it is the mean of zero values
    pool = KVPool(1, 2, 4, 4, 8, device="cpu", quant_dtype="int8")
    q = torch.randn(2, 2, 8)
    out = pa.paged_attention(q, pool.k[0], pool.v[0],
                             torch.zeros(2, 2, dtype=torch.int32),
                             torch.tensor([1, 6], dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


def test_int8_pairs_rejected_when_mixed():
    pool = KVPool(1, 2, 4, 4, 8, device="cpu", quant_dtype="int8")
    # a float entry of the pool's page shape (its 4 pages and the sink)
    flt = torch.zeros(pool.k[0][0].shape)
    with pytest.raises(ValueError, match="both"):
        pa.paged_attention(torch.zeros(1, 2, 8), pool.k[0], flt,
                           torch.zeros(1, 1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="quant_dtype"):
        KVPool(1, 2, 4, 4, 8, device="cpu", quant_dtype="fp8")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        EngineConfig(kv_cache_dtype="fp8")


def test_int8_pool_bytes_at_most_half_of_f32():
    f32 = KVPool(2, 2, 4, 4, 8, device="cpu")
    int8 = KVPool(2, 2, 4, 4, 8, device="cpu", quant_dtype="int8")
    # the JAX package's figure: layers * K/V * heads * (d + 4)
    assert int8.bytes_per_token() == 2 * 2 * 2 * (8 + 4)
    assert int8.bytes_per_token() <= 0.5 * f32.bytes_per_token()
    assert int8.nbytes() == int8.bytes_per_token() * 16
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    cfg = dict(max_batch_slots=2, max_model_len=32, page_size=4)
    a = Engine(model, EngineConfig(**cfg, kv_cache_dtype="int8"))
    b = Engine(model, EngineConfig(**cfg))
    assert a.pool.bytes_per_token() <= 0.5 * b.pool.bytes_per_token()
    assert all(k[0].dtype == torch.int8 and k[1].dtype == torch.float32
               for k in a.pool.k)


# ---------------------------------------------------------------- engine
def _models(kv):
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(num_key_value_heads=kv))
    port = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv),
                            device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return jax_model, port


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def models(request):
    return _models(request.param)


def test_int8_adapter_prefill_pool_and_decode_logits(models):
    jax_model, port = models
    cfg = port.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    geo = (cfg.num_hidden_layers, cfg.num_key_value_heads, 8, 4, head_dim)
    jpool = jax_serving.KVPool(*geo, quant_dtype="int8")
    tpool = KVPool(*geo, device="cpu", quant_dtype="int8")
    jad, tad = JaxAdapter(jax_model), LlamaServingAdapter(port)
    prompt = np.random.RandomState(9).randint(1, 128, 16).astype(np.int64)
    table = np.array([3, 0, 5, 1], np.int32)   # 13 tokens on 4 pages
    # jitted as the JAX engine runs them (eager JAX is slow op by op)
    _, jk, jv = jax.jit(jad.prefill)(jad.weights, jpool.k, jpool.v,
                                     jnp.asarray(prompt), 13,
                                     jnp.asarray(table))
    tad.prefill(tpool.k, tpool.v, torch.from_numpy(prompt), 13,
                torch.from_numpy(table))
    # the port's pool ends in the sink page (the padded prompt rows land
    # there), which JAX's has not: the live pages are compared
    for jside, tside in ((jk, tpool.k), (jv, tpool.v)):
        for (jq8, js), (tq8, ts) in zip(jside, tside):
            diff = np.abs(tq8.numpy()[:, :-1].astype(np.int32)
                          - np.asarray(jq8).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            np.testing.assert_allclose(ts.numpy()[:, :-1], np.asarray(js),
                                       rtol=1e-5, atol=0)
    # one decode step over both pools: slot 0 continues the prompt at
    # position 13, slot 1 is inactive
    tokens = np.array([7, 0], np.int64)
    positions = np.array([13, 0], np.int64)
    tables = np.stack([table, np.zeros(4, np.int32)])
    active = np.array([True, False])
    jlog, _, _ = jax.jit(jad.decode)(jad.weights, jk, jv, *map(jnp.asarray, (
        tokens, positions, tables, active)))
    tlog = tad.decode(tpool.k, tpool.v, *_t(tokens, positions, tables,
                                             active))
    np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog)[0],
                               rtol=1e-4, atol=1e-4)


def test_int8_engine_greedy_matches_jax_engine(models):
    jax_model, port = models
    rng = np.random.RandomState(3)
    lens = rng.choice([4, 7, 10, 13], 8)
    prompts = [rng.randint(1, 128, n).tolist() for n in lens]
    max_new = [int(24 - n) for n in lens]
    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(
        max_batch_slots=4, max_model_len=64, page_size=8,
        kv_cache_dtype="int8",
    ))
    ref = jeng.generate(
        prompts,
        [jax_serving.SamplingParams(max_new_tokens=k) for k in max_new],
    )
    eng = Engine(port, EngineConfig(max_batch_slots=4, max_model_len=64,
                                    page_size=8, kv_cache_dtype="int8"))
    out = eng.generate(prompts,
                       [SamplingParams(max_new_tokens=k) for k in max_new])
    assert [o.token_ids for o in out] == [o.token_ids for o in ref]
    assert eng.block_manager.num_used == 0


def test_int8_engine_preemption_and_abort():
    # recompute preemption and abort over (pages, scales) pairs: a starved
    # int8 engine gives the roomy int8 engine's tokens, and frees all
    _, port = _models(None)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 128, n).tolist() for n in (4, 7, 10, 13) * 2]
    params = [SamplingParams(max_new_tokens=20 - len(p)) for p in prompts]
    cfg = dict(max_batch_slots=4, max_model_len=32, page_size=4,
               prefill_buckets=[16, 32], kv_cache_dtype="int8")
    roomy = Engine(port, EngineConfig(**cfg))
    starved = Engine(port, EngineConfig(**cfg, num_blocks=10))
    ref = [o.token_ids for o in roomy.generate(prompts, params)]
    out = [o.token_ids for o in starved.generate(prompts, params)]
    assert starved.metrics.preemptions > 0 and out == ref
    assert starved.block_manager.num_used == 0
    req = starved.add_request(prompts[0], SamplingParams(max_new_tokens=8))
    starved.step()
    assert starved.abort(req.request_id)
    assert [o.finish_reason for o in starved.step()] == ["aborted"]
    assert starved.block_manager.num_used == 0
