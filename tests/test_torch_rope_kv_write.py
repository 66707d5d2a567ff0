"""``kernels.rope_kv_write``: RoPE folded into the serving page write, on
the CPU.

* ``rope_kv_write_ref`` (the plain version the kernel is held to on the
  card by ``chip_smoke.py``) against the JAX package: the rotation of
  ``rope_qk`` (``fused_rotary_position_embedding`` with the same angle
  table) then the JAX page write of each serving program: ``update_pages``
  (decode: a row at capacity, one past it, an inactive slot), the
  adapter's ``_write_chunk_pages`` (prefill with a cache offset and a
  padded tail) and ``_write_window_pages`` over ``_window_routing``
  (verify: padded drafts, an inactive slot, a window crossing capacity);
  f32, bf16 and int8 pools (int8 with f32 and bf16 rows), MHA and GQA.
  Exact: q, k, the live pages, int8 codes and scales. Given the same
  table both sides round the same f32 products and sums once each; the
  port's ``rope_table`` itself is within one f32 step (2^-23 absolute on
  values in [-1, 1]) of JAX's ``_build_rope_cache``, as XLA's and
  PyTorch's ``cos``/``sin`` differ in the last bit.
* The four adapter programs (``prefill``, ``prefill_ext``, ``decode``,
  ``verify``) on the rotating write against the same programs with the
  write swapped for the composition they ran before: ``rope_qk`` at the
  rows' positions, then ``kv_write_ref``: logits and every pool tensor
  bit-identical, f32 and int8 pools, MHA and GQA.
* The rope table is built once per program call, not once per layer.
* The wrapper takes the plain version for CPU tensors (uncounted) and
  raises on a wrong shape, dtype or device; on tensors that report a
  CUDA device it raises on what the kernel does not take, never falling
  back to the plain version; its ctypes declarations follow the C
  signatures of both entry points of ``csrc/kv_write.cu``.
"""
import ctypes
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import paged_attention as jpa
from paddle_tpu.ops.impl.fused_ops import (
    _build_rope_cache,
    fused_rotary_position_embedding,
)
from paddle_tpu.serving.adapter import _window_routing
from paddle_tpu.serving.adapter import _write_chunk_pages as jax_write_chunk
from paddle_tpu.serving.adapter import _write_window_pages
from paddle_tpu_torch.kernels import _build, launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels import kv_write as kvw
from paddle_tpu_torch.kernels.kv_write import (
    kv_write_ref,
    rope_kv_write,
    rope_kv_write_ref,
)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.fused_ops import rope_qk, rope_table
from paddle_tpu_torch.serving import KVPool
from paddle_tpu_torch.serving import adapter as adapter_mod
from paddle_tpu_torch.serving.adapter import LlamaServingAdapter

HKV, PAGES, PAGE, D = 2, 6, 4, 16
BASE = 10000.0
# pool -> (row dtype, int8 pool)
POOLS = {"f32": (np.float32, False), "bf16": (jnp.bfloat16, False),
         "int8": (np.float32, True), "int8_bf16": (jnp.bfloat16, True)}
TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("base", [10000.0, 500000.0])
def test_rope_table_matches_jax_cache(base):
    pos = np.array([[0, 1, 7, 95, 511, 4097]], np.int32)
    cos, sin = rope_table(torch.from_numpy(pos), 32, base)
    jc, js = _build_rope_cache(pos.shape[1], 32, base, jnp.float32,
                               jnp.asarray(pos))
    assert cos.dtype == sin.dtype == torch.float32
    assert cos.shape == (1, 6, 16)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), rtol=0,
                               atol=2.0 ** -23)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), rtol=0,
                               atol=2.0 ** -23)


def _jax_pool(seed, dtype, quant):
    rng = np.random.RandomState(seed)
    pages = [rng.randn(HKV, PAGES, PAGE, D).astype(np.float32)
             for _ in range(2)]
    if quant:
        return [jpa.quantize_tokens(jnp.asarray(p)) for p in pages]
    return [jnp.asarray(p).astype(dtype) for p in pages]


def _port_entry(entry):
    """The port's pool entry from a JAX one: the same pages plus the sink
    page (float pages in the rows' torch dtype)."""
    def one(a):
        t = torch.from_numpy(np.array(a, np.float32) if a.dtype != np.int8
                             else np.array(a))
        if a.dtype == jnp.bfloat16:
            t = t.to(torch.bfloat16)
        return torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
    if isinstance(entry, tuple):
        return tuple(one(a) for a in entry)
    return one(entry)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _routing(kind, n):
    """(JAX write of one pool entry given rotated rows, the port's
    block_tables, rows, positions, valid) for ``n`` new rows."""
    if kind == "decode":
        # slot 1 at capacity (8), slot 2 past it, slot 3 inactive
        bt = np.array([[0, 1], [2, 3], [5, 4], [3, 2]], np.int32)
        lens = np.array([5, 8, 11, 2], np.int32)
        active = np.array([True, True, True, False])
        jlens = np.where(active, lens, bt.shape[1] * PAGE).astype(np.int32)

        def write(entry, new, other, other_new):
            return jpa.update_pages(entry, other, new, other_new,
                                    jnp.asarray(bt), jnp.asarray(jlens))
        return write, bt, np.arange(n, dtype=np.int32), lens, active
    if kind == "prefill":
        # an 8-token bucket, 5 tokens after 4 cached, table capacity 12
        table = np.array([4, 1, 0], np.int32)
        t = np.arange(n, dtype=np.int32)

        def write(entry, new, other, other_new):
            return (jax_write_chunk(entry, new, jnp.asarray(table), 5, 4),
                    jax_write_chunk(other, other_new, jnp.asarray(table), 5,
                                    4))
        return write, table[None], np.zeros(n, np.int32), 4 + t, t < 5
    # verify: 2 slots x 4-token windows, capacity 8; slot 0's window
    # crosses capacity, slot 1 is inactive
    bt = np.array([[1, 5], [0, 3]], np.int32)
    positions = np.array([6, 2], np.int32)
    draft_lens = np.array([3, 1], np.int32)
    active = np.array([True, False])
    offs = np.arange(4, dtype=np.int32)[None]
    pos = positions[:, None] + offs
    valid = active[:, None] & (offs <= draft_lens[:, None]) & (pos < 8)
    phys, slot = _window_routing(jnp.asarray(bt), jnp.asarray(pos),
                                 jnp.asarray(valid), PAGES, PAGE)

    def write(entry, new, other, other_new):
        return (_write_window_pages(entry, new.reshape(2, 4, HKV, D), phys,
                                    slot),
                _write_window_pages(other, other_new.reshape(2, 4, HKV, D),
                                    phys, slot))
    return (write, bt, np.repeat(np.arange(2, dtype=np.int32), 4),
            pos.reshape(-1), valid.reshape(-1))


@pytest.mark.parametrize("kind,n", [("decode", 4), ("prefill", 8),
                                    ("verify", 8)])
@pytest.mark.parametrize("hq", [2, 4], ids=["mha", "gqa"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_rope_kv_write_ref_matches_jax_rope_and_page_write(pool, hq, kind,
                                                           n):
    dtype, quant = POOLS[pool]
    rng = np.random.RandomState(11)
    q = (rng.randn(n, hq, D) * 2).astype(np.float32)
    k = (rng.randn(n, HKV, D) * 3).astype(np.float32)
    v = rng.randn(n, HKV, D).astype(np.float32)
    k[0, 0] = 0.0                                 # an all-zero row
    write, tables, rows, positions, valid = _routing(kind, n)
    cos, sin = rope_table(torch.from_numpy(positions), D, BASE)
    # JAX: rope_qk's rotation on the same table, then its page write
    jq, jk = fused_rotary_position_embedding(
        jnp.asarray(q).astype(dtype)[None], jnp.asarray(k).astype(dtype)[None],
        cos=cos.numpy(), sin=sin.numpy())[:2]
    jkp, jvp = _jax_pool(12, dtype, quant)
    jk_pages, jv_pages = write(jkp, jk[0], jvp, jnp.asarray(v).astype(dtype))
    # the port
    tdt = TORCH[dtype]
    tkp, tvp = _port_entry(jkp), _port_entry(jvp)
    tq, tk = rope_kv_write_ref(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), cos, sin, tkp, tvp,
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (tables, rows, positions, valid)), want_k=True)
    assert tq.dtype == tk.dtype == tdt
    np.testing.assert_array_equal(_numpy(tq), _numpy(jq[0]))
    np.testing.assert_array_equal(_numpy(tk), _numpy(jk[0]))
    got = [t for e in (tkp, tvp) for t in (e if quant else (e,))]
    want = [a for e in (jk_pages, jv_pages) for a in (e if quant else (e,))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_numpy(g[:, :-1]), _numpy(w))


def test_rope_kv_write_takes_the_plain_version_on_the_cpu_uncounted():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(3, h, D).astype(np.float32))
               for h in (4, HKV, HKV))
    pos = torch.tensor([0, 5, 9], dtype=torch.int32)
    cos, sin = rope_table(pos, D)
    args = (torch.tensor([[2, 3, 4]], dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32), pos,
            torch.tensor([True, True, False]))

    def pool():
        return [torch.zeros(HKV, PAGES + 1, PAGE, D) for _ in range(2)]

    reset_launch_counts()
    got_pool, want_pool = pool(), pool()
    got = rope_kv_write(q, k, v, cos, sin, *got_pool, *args, want_k=True)
    want = rope_kv_write_ref(q, k, v, cos, sin, *want_pool, *args,
                             want_k=True)
    assert set(launch_counts().values()) == {0}
    for a, b in zip(list(got) + got_pool, list(want) + want_pool):
        assert torch.equal(a, b)
    q_only = rope_kv_write(q, k, v, cos, sin, *pool(), *args)
    assert torch.equal(q_only, want[0])
    # position 0 -> page 2, slot 0: the rotated k, the plain v
    assert torch.equal(got_pool[0][:, 2, 0], want[1][0])
    assert torch.equal(got_pool[1][:, 2, 0], v[0])


def _bad(case):
    """rope_kv_write's arguments (valid, 2 rows, hq 4), with ``case``
    broken."""
    q, k, v = (torch.zeros(2, h, D) for h in (4, HKV, HKV))
    cos, sin = torch.ones(2, D // 2), torch.zeros(2, D // 2)
    kp, vp = (torch.zeros(HKV, PAGES + 1, PAGE, D) for _ in range(2))
    tables = torch.zeros(1, 2, dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32)
    pos = torch.arange(2, dtype=torch.int32)
    valid = torch.ones(2, dtype=torch.bool)
    if case == "q_head_dim":
        q = torch.zeros(2, 4, D + 2)
    elif case == "q_rows":
        q = torch.zeros(3, 4, D)
    elif case == "odd_head_dim":
        q, k, v = (torch.zeros(2, h, 15) for h in (4, HKV, HKV))
        kp, vp = (torch.zeros(HKV, PAGES + 1, PAGE, 15) for _ in range(2))
    elif case == "cos_shape":
        cos = torch.ones(2, D)
    elif case == "positions_shape":
        pos = torch.arange(3, dtype=torch.int32)
    elif case == "cos_dtype":
        cos = cos.double()
    elif case == "q_dtype":
        q = q.to(torch.bfloat16)
    elif case == "int8_pages_without_scales":
        kp = (kp.to(torch.int8), torch.zeros(HKV, PAGES + 1, PAGE))
    elif case == "meta_device":
        q, k, v, cos, sin = (t.to("meta") for t in (q, k, v, cos, sin))
    elif case == "mixed_devices":
        sin = sin.to("meta")
    return q, k, v, cos, sin, kp, vp, tables, rows, pos, valid


@pytest.mark.parametrize("case,error", [
    ("q_head_dim", ValueError), ("q_rows", ValueError),
    ("odd_head_dim", ValueError), ("cos_shape", ValueError),
    ("positions_shape", ValueError), ("cos_dtype", TypeError),
    ("q_dtype", TypeError), ("int8_pages_without_scales", ValueError),
    ("meta_device", ValueError), ("mixed_devices", ValueError),
])
def test_rope_kv_write_rejects_wrong_inputs(case, error):
    with pytest.raises(error, match="rope_kv_write"):
        rope_kv_write(*_bad(case))


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: takes the wrapper down its
    kernel path on a host with no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("case,error,match", [
    ("f64_rows", TypeError, "float32, bfloat16 or float16"),
    ("pages_of_another_dtype", TypeError, "new rows' dtype"),
    ("head_dim_258", ValueError, "head_dim 258"),
    ("table_on_the_cpu", ValueError, "a tensor is on cpu"),
])
def test_rope_kv_write_on_cuda_raises_rather_than_falls_back(
        case, error, match, monkeypatch):
    def no_launch():
        raise AssertionError("the kernel was about to launch")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kvw, "_kernel", no_launch)
    monkeypatch.setattr(kvw, "rope_kv_write_ref", no_plain)
    d = 258 if case == "head_dim_258" else D
    dtype = torch.float64 if case == "f64_rows" else torch.float32
    page_dtype = torch.bfloat16 if case == "pages_of_another_dtype" else dtype

    def cuda(t):
        return t.as_subclass(_OnCuda)

    q, k, v = (cuda(torch.zeros(2, h, d, dtype=dtype)) for h in (4, HKV, HKV))
    cos, sin = (cuda(torch.zeros(2, d // 2)) for _ in range(2))
    kp, vp = (cuda(torch.zeros(HKV, PAGES + 1, PAGE, d, dtype=page_dtype))
              for _ in range(2))
    tables = torch.zeros(1, 2, dtype=torch.int32)
    if case != "table_on_the_cpu":
        tables = cuda(tables)
    routing = (cuda(torch.zeros(2, dtype=torch.int32)),
               cuda(torch.arange(2, dtype=torch.int32)),
               cuda(torch.ones(2, dtype=torch.bool)))
    reset_launch_counts()
    with pytest.raises(error, match=match):
        rope_kv_write(q, k, v, cos, sin, kp, vp, tables, *routing)
    assert launch_counts()["rope_kv_write"] == 0


def test_kv_write_abi_matches_the_c_signatures(monkeypatch):
    # the ctypes argument types the wrapper declares follow each C launch
    # function's parameters one for one (pointers, then ints, then the
    # stream)
    src = (_build.CSRC_DIR / "kv_write.cu").read_text()

    def c_params(fn):
        (sig,) = re.findall(rf'extern "C" int {fn}\(([^)]*)\)', src)
        params = [" ".join(p.split()) for p in sig.split(",")]
        return ([p.split()[-1].lstrip("*") for p in params],
                [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params])

    names, want = c_params("rope_kv_write_launch")
    assert names[:7] == ["q", "k", "v", "cos_t", "sin_t", "q_out", "k_out"]
    assert names[-4:] == ["dtype", "quant", "vec", "stream"]
    kv_names, kv_want = c_params("kv_write_launch")
    assert kv_names[:2] == ["k_new", "v_new"]
    lib = SimpleNamespace(kv_write_launch=SimpleNamespace(),
                          rope_kv_write_launch=SimpleNamespace())
    monkeypatch.setattr(kvw, "_lib", None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert kvw._kernel() is lib
    assert lib.rope_kv_write_launch.argtypes == want
    assert lib.kv_write_launch.argtypes == kv_want
    assert lib.rope_kv_write_launch.restype is ctypes.c_int
    assert lib.kv_write_launch.restype is ctypes.c_int


# ------------------------------------------------------------- programs
@pytest.fixture(scope="module", params=["mha", "gqa"])
def adapter(request):
    kv = 2 if request.param == "gqa" else None
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=kv),
                             device="cpu", seed=0)
    return LlamaServingAdapter(model)


def _filled_pool(ad, kv, seed):
    pool = KVPool(ad.num_layers, ad.num_kv_heads, 24, 4, ad.head_dim,
                  device="cpu", quant_dtype=kv)
    g = torch.Generator().manual_seed(seed)
    for entry in pool.k + pool.v:
        for t in (entry if isinstance(entry, tuple) else (entry,)):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.copy_(torch.rand(t.shape, generator=g))
    return pool


def _run(ad, program, pool):
    """One call of ``program`` over ``pool`` at fixed inputs: every
    routing case of the write (a padded tail, an inactive slot, a row at
    capacity, a verify window crossing it)."""
    rng = np.random.RandomState(5)
    if program == "prefill":
        return ad.prefill(pool.k, pool.v, torch.from_numpy(rng.randint(
            1, 128, 8)), 5, torch.tensor([3, 7, 1, 0], dtype=torch.int32))
    if program == "prefill_ext":
        return ad.prefill_ext(
            pool.k, pool.v, torch.from_numpy(rng.randint(1, 128, 8)),
            torch.tensor(5), torch.tensor(6),
            torch.tensor([3, 7, 1, 0], dtype=torch.int32))
    tables = torch.from_numpy(rng.permutation(24)[:16].reshape(4, 4)
                              .astype(np.int32))          # capacity 16
    active = torch.tensor([True, True, False, True])
    if program == "decode":
        return ad.decode(pool.k, pool.v,
                         torch.from_numpy(rng.randint(1, 128, 4)),
                         torch.tensor([5, 15, 2, 16], dtype=torch.int32),
                         tables, active)
    return ad.verify(pool.k, pool.v,
                     torch.from_numpy(rng.randint(1, 128, (4, 4))),
                     torch.tensor([5, 13, 2, 0], dtype=torch.int32),
                     torch.tensor([3, 3, 1, 0], dtype=torch.int32), tables,
                     active)


PROGRAMS = ["prefill", "prefill_ext", "decode", "verify"]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("program", PROGRAMS)
def test_programs_bit_identical_to_rope_qk_then_kv_write(adapter, program,
                                                         kv, monkeypatch):
    new_pool, old_pool = _filled_pool(adapter, kv, 1), _filled_pool(
        adapter, kv, 1)
    new = _run(adapter, program, new_pool)

    def rope_qk_then_kv_write(q, k, v, cos, sin, k_pages, v_pages,
                              block_tables, rows, positions, valid, *,
                              want_k=False):
        qr, kr = rope_qk(q[None], k[None], positions[None],
                         base=adapter.rope_theta)
        kv_write_ref(k_pages, v_pages, kr[0], v, block_tables, rows,
                     positions, valid)
        return (qr[0], kr[0]) if want_k else qr[0]

    monkeypatch.setattr(adapter_mod, "rope_kv_write", rope_qk_then_kv_write)
    old = _run(adapter, program, old_pool)
    assert torch.equal(new, old)
    for a, b in zip(new_pool.k + new_pool.v, old_pool.k + old_pool.v):
        for x, y in zip(a if kv else (a,), b if kv else (b,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("program", PROGRAMS)
def test_rope_table_built_once_per_program_call(adapter, program,
                                                monkeypatch):
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return rope_table(*args, **kwargs)

    monkeypatch.setattr(adapter_mod, "rope_table", counted)
    assert adapter.num_layers >= 2
    _run(adapter, program, _filled_pool(adapter, None, 2))
    assert len(calls) == 1
