"""The serving engine's step programs and their page write, on the CPU.

* ``kernels.kv_write_ref`` (the plain version of the fused KV-write
  kernel) against the JAX package's page writes on the same numpy
  inputs: ``update_pages`` (decode routing) and the adapter's
  ``_write_chunk_pages`` (prefill routing, with and without a cache
  offset), float and int8 pools, rows at capacity, inactive rows and a
  padded prompt tail included. Live pages and scales are bit-identical;
  the rows that must not be written land in the sink page, which no
  attention reads (a NaN sink leaves the attention output unchanged).
* The decode and prefill programs are shape-static and free of host
  syncs: run under a ``TorchDispatchMode`` that fails on
  ``aten._local_scalar_dense`` (``.item()``, ``int(t)``), ``aten.nonzero``,
  ``aten.masked_select``, ``aten.lift_fresh`` (a host value entering the
  program) and any copy between devices, they finish (the CPU stand-in for
  "capturable": on the card the same functions are captured into CUDA
  graphs).
* Compile counters, as the JAX tests pin them
  (``tests/test_serving.py:181/182/639/920``): ``decode_compiles == 1``
  all-greedy, ``<= 2`` mixed, ``prefill_compiles <= len(buckets)``; and
  against the JAX engine on converted weights, greedy tokens identical in
  f32 with the same decode and prefill program counts.
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
from paddle_tpu.serving.adapter import _write_chunk_pages as jax_write_chunk
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.kv_write import kv_write, kv_write_ref
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

# exact: the page write moves or quantizes values, it sums nothing
HKV, PAGES, PAGE, D = 2, 6, 4, 16


def _pool(seed, quant):
    """A JAX-layout pool entry pair (numpy), float or int8 pairs."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(HKV, PAGES, PAGE, D).astype(np.float32)
    vp = rng.randn(HKV, PAGES, PAGE, D).astype(np.float32)
    if not quant:
        return kp, vp
    return (tuple(np.asarray(a) for a in jpa.quantize_tokens(jnp.asarray(kp))),
            tuple(np.asarray(a) for a in jpa.quantize_tokens(jnp.asarray(vp))))


def _port(entry, sink_fill=0.0):
    """The port's pool entry: the same pages plus the sink page."""
    def one(a):
        t = torch.from_numpy(np.array(a))
        sink = torch.full_like(t[:, :1], sink_fill)
        return torch.cat([t, sink], dim=1)
    if isinstance(entry, tuple):
        return tuple(one(a) for a in entry)
    return one(entry)


def _live(entry):
    """The live pages (and scales) of a port entry, as numpy."""
    if isinstance(entry, tuple):
        return [t[:, :-1].numpy() for t in entry]
    return [entry[:, :-1].numpy()]


def _flat(entry):
    return [np.asarray(a) for a in (entry if isinstance(entry, tuple)
                                    else (entry,))]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("lens,active", [
    ([5, 8, 0], [True, True, True]),        # partial, at capacity, empty
    ([7, 3, 2], [True, False, True]),       # last slot, an inactive row
    ([8, 8, 1], [False, True, True]),       # inactive at capacity
])
def test_kv_write_ref_decode_routing_matches_update_pages(quant, lens,
                                                          active):
    kp, vp = _pool(1, quant)
    rng = np.random.RandomState(2)
    kn = rng.randn(3, HKV, D).astype(np.float32) * 3.0
    vn = rng.randn(3, HKV, D).astype(np.float32)
    kn[0, 0] = 0.0                             # an all-zero token
    bt = np.array([[0, 1], [2, 3], [5, 4]], np.int32)   # capacity 8
    lens, active = np.array(lens, np.int32), np.array(active)
    # JAX's engine marks an inactive slot by a length at capacity
    jlens = np.where(active, lens, bt.shape[1] * PAGE).astype(np.int32)
    jk, jv = jpa.update_pages(*(jax.tree_util.tree_map(jnp.asarray, x)
                                for x in (kp, vp, kn, vn, bt, jlens)))
    tk, tv = _port(kp), _port(vp)
    kv_write_ref(tk, tv, *_t(kn, vn, bt, np.arange(3, dtype=np.int32),
                             lens, active))
    for got, want in zip(_live(tk) + _live(tv), _flat(jk) + _flat(jv)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("length,cache_len", [(5, 0), (8, 0), (3, 4),
                                              (0, 0)])
def test_kv_write_ref_prefill_routing_matches_jax_prompt_write(
        quant, length, cache_len):
    kp, vp = _pool(3, quant)
    s = 8                                      # a bucket of 8, padded
    rng = np.random.RandomState(4)
    kn = rng.randn(s, HKV, D).astype(np.float32)
    vn = rng.randn(s, HKV, D).astype(np.float32) * 0.1
    table = np.array([4, 1, 0], np.int32)      # capacity 12
    jk = jax_write_chunk(jax.tree_util.tree_map(jnp.asarray, kp),
                         jnp.asarray(kn), jnp.asarray(table), length,
                         cache_len)
    jv = jax_write_chunk(jax.tree_util.tree_map(jnp.asarray, vp),
                         jnp.asarray(vn), jnp.asarray(table), length,
                         cache_len)
    tk, tv = _port(kp), _port(vp)
    t = np.arange(s, dtype=np.int32)
    kv_write_ref(tk, tv, *_t(kn, vn, table[None], np.zeros(s, np.int32),
                             cache_len + t, t < length))
    for got, want in zip(_live(tk) + _live(tv), _flat(jk) + _flat(jv)):
        np.testing.assert_array_equal(got, want)


def test_kv_write_takes_the_plain_version_on_the_cpu_uncounted():
    kp, vp = _port(_pool(5, False)[0]), _port(_pool(5, False)[1])
    kn = torch.ones(2, HKV, D)
    reset_launch_counts()
    kv_write(kp, vp, kn, kn, torch.tensor([[2, 3]], dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32),
             torch.tensor([0, 9], dtype=torch.int32),
             torch.tensor([True, True]))
    assert launch_counts()["kv_write"] == 0
    assert bool((kp[:, 2, 0] == 1).all())      # position 0 -> page 2
    with pytest.raises(ValueError, match="rows"):
        kv_write(kp, vp, kn, kn, torch.zeros(1, 2, dtype=torch.int32),
                 torch.zeros(3, dtype=torch.int32),
                 torch.zeros(2, dtype=torch.int32),
                 torch.ones(2, dtype=torch.bool))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_sink_page_is_never_read(quant):
    # rows routed to the sink, then attention over every table: a sink
    # full of NaN changes nothing
    kp, vp = _pool(6, quant)
    kn = np.random.RandomState(7).randn(2, HKV, D).astype(np.float32)
    bt = np.array([[0, 1], [2, 3]], np.int32)
    args = _t(kn, kn, bt, np.arange(2, dtype=np.int32),
              np.array([3, 8], np.int32), np.array([True, True]))
    q = torch.from_numpy(
        np.random.RandomState(8).randn(2, 2 * HKV, D).astype(np.float32))
    lens = torch.tensor([4, 8], dtype=torch.int32)
    outs = []
    for fill in (0.0, float("nan")):
        tk = _port(kp, fill if not quant else 0.0)
        tv = _port(vp, fill if not quant else 0.0)
        if quant:   # the scales of the sink are what an int8 read scales by
            tk[1][:, -1] = fill
            tv[1][:, -1] = fill
        kv_write_ref(tk, tv, *args)
        outs.append(pa.paged_attention_ref(q, tk, tv, args[2], lens))
    assert bool(torch.isfinite(outs[1]).all())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


# ------------------------------------------------------------ programs
class NoHostSync(TorchDispatchMode):
    """Fails on any op that reads a device value on the host, takes a
    data-dependent shape, or copies host data into the program."""

    FORBIDDEN = {
        torch.ops.aten._local_scalar_dense.default,
        torch.ops.aten.nonzero.default,
        torch.ops.aten.masked_select.default,
        torch.ops.aten.lift_fresh.default,
        torch.ops.aten.item.default,
        torch.ops.aten.is_nonzero.default,
    }

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.FORBIDDEN:
            raise AssertionError(f"host sync in a program: {func}")
        if (func is torch.ops.aten._to_copy.default
                and kwargs.get("device") not in (None, args[0].device)):
            raise AssertionError(
                f"copy from {args[0].device} to {kwargs['device']}")
        self.ops.add(func)
        return func(*args, **kwargs)


def test_guard_catches_a_host_sync():
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            int(torch.ones(2).sum())
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            torch.nonzero(torch.ones(3))
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            torch.tensor([1.0, 2.0])
    with pytest.raises(AssertionError, match="to meta"):
        with NoHostSync():
            torch.ones(2).to("meta")


@pytest.fixture(scope="module")
def tiny():
    return LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                            device="cpu", seed=0)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_programs_are_shape_static_and_sync_free(tiny, kv_cache_dtype):
    eng = Engine(tiny, EngineConfig(max_batch_slots=3, max_model_len=32,
                                    page_size=4, prefill_buckets=[16, 32],
                                    kv_cache_dtype=kv_cache_dtype))
    sampled = SamplingParams(max_new_tokens=4, do_sample=True, top_k=5,
                             top_p=0.9, temperature=0.7)
    eng.add_request([3, 1, 4, 1, 5], sampled)
    eng.add_request([2, 7, 1], SamplingParams(max_new_tokens=4))
    eng.step()                  # builds the prefill and decode programs
    prefill = eng._prefill_programs[16]
    decode = eng._decode_programs[True]
    eng._prefill_buffers.stage()
    eng._decode_buffers.stage()
    for prog in (prefill, decode):
        with NoHostSync() as guard:
            tok, logits = prog.fn()
        assert any("sort" in str(op) for op in guard.ops)   # warp ran
        assert logits.shape[-1] == tiny.config.vocab_size
    assert tok.shape == (3,)


def _drain(engine, prompts, params):
    return [o.token_ids for o in engine.generate(prompts, params)]


def test_compile_counters_greedy_mixed_and_buckets(tiny):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, int(n)).tolist()
               for n in rng.choice([3, 9, 14, 20], 10)]
    cfg = EngineConfig(max_batch_slots=4, max_model_len=32, page_size=4,
                       prefill_buckets=[8, 16, 32])
    eng = Engine(tiny, cfg)
    _drain(eng, prompts, SamplingParams(max_new_tokens=6))
    _drain(eng, prompts[:4], SamplingParams(max_new_tokens=3))
    # all greedy: ONE decode program; at most one prefill program per
    # bucket, however many requests and generate() calls
    assert eng.metrics.decode_compiles == 1
    assert eng.metrics.prefill_compiles <= len(cfg.prefill_buckets)
    mixed = [SamplingParams(max_new_tokens=5, do_sample=i % 4 == 3,
                            temperature=0.8) for i in range(len(prompts))]
    _drain(eng, prompts, mixed)
    _drain(eng, prompts, mixed)
    assert eng.metrics.decode_compiles == 2
    assert eng.metrics.prefill_compiles <= len(cfg.prefill_buckets)
    assert eng.block_manager.num_used == 0


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_programs_match_jax_engine_tokens_and_program_counts(kv):
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(num_key_value_heads=kv))
    port = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv),
                            device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    rng = np.random.default_rng(11)
    lens = [int(n) for n in rng.choice([4, 9, 15, 21], 8)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [30 - n for n in lens]
    geo = dict(max_batch_slots=4, max_model_len=32, page_size=4,
               prefill_buckets=[8, 16, 32])
    jeng = jax_serving.Engine(jax_model, jax_serving.EngineConfig(**geo))
    ref = jeng.generate(prompts, [jax_serving.SamplingParams(
        max_new_tokens=k) for k in max_new])
    eng = Engine(port, EngineConfig(**geo))
    out = eng.generate(prompts, [SamplingParams(max_new_tokens=k)
                                 for k in max_new])
    assert [o.token_ids for o in out] == [o.token_ids for o in ref]
    assert eng.metrics.decode_compiles == jeng.metrics.decode_compiles == 1
    assert eng.metrics.prefill_compiles == jeng.metrics.prefill_compiles
    assert eng.metrics.decode_steps == jeng.metrics.decode_steps


def test_programs_are_built_over_inert_inputs(tiny):
    # on the card a program's build runs its function once eagerly before
    # the capture; over the last step's staged inputs that warm-up would
    # write K/V into pages another request may own by now. The engine
    # zeroes the static buffers first (no active slot, length 0).
    eng = Engine(tiny, EngineConfig(max_batch_slots=2, max_model_len=32,
                                    page_size=4, prefill_buckets=[8, 32]))
    build, seen = eng._program, []

    def checked(fn, generator):
        # the buffer the program being built reads: prefill programs draw
        # from the prefill generator
        bufs = (eng._prefill_buffers if generator is eng._prefill_generator
                else eng._decode_buffers)
        seen.append(not bool(bufs.device.any()))
        return build(fn, generator)

    eng._program = checked
    eng.generate([[1, 2, 3]], SamplingParams(max_new_tokens=3))
    eng.generate([list(range(1, 20))], SamplingParams(
        max_new_tokens=3, do_sample=True))
    assert eng.metrics.prefill_compiles == 2 == eng.metrics.decode_compiles
    assert seen == [True] * 4
