"""The port's kernel modules against the JAX package's kernels, on the CPU.

The JAX side runs as its own tests run it off-TPU: the Pallas kernels in
interpret mode (``_compat.interpret_mode()``), beside their XLA
references. The port's side is the plain PyTorch version of each kernel,
which its wrapper takes for CPU tensors (the CUDA kernels themselves run
only on the card: ``chip_smoke.py`` holds them against these plain
versions there). f32 tolerance atol 2e-5, rtol 2e-5 for the paged cases
(the JAX package's own kernel-vs-reference tolerance), atol 1e-5, rtol
1e-4 elsewhere. The flash backward's gradients through
``FlashAttentionFunction`` are also held to autograd through the math
attention, and to finite differences in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import flash_attention as jfa
from paddle_tpu.kernels.pallas import paged_attention as jpa
from paddle_tpu.ops.impl.nn_ops import (
    scaled_dot_product_attention as jax_sdpa,
)
from paddle_tpu_torch.kernels import (
    launch_counts,
    reset_launch_counts,
    variant_counts,
)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.ops import scaled_dot_product_attention as port_sdpa

PAGED_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-5, rtol=1e-4)


def _pool(seed=0, kvh=2, pages=10, bs=8, d=32):
    rng = np.random.RandomState(seed)
    kp = rng.randn(kvh, pages, bs, d).astype(np.float32)
    vp = rng.randn(kvh, pages, bs, d).astype(np.float32)
    return kp, vp


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _paged_cases():
    # the TestPagedAttention sweep: a length-0 slot, a mid-page partial
    # last block, a page-aligned length and full capacity; GQA group 2
    kp, vp = _pool()
    rng = np.random.RandomState(1)
    q = rng.randn(4, 4, 32).astype(np.float32)
    bt = rng.randint(0, 10, (4, 3)).astype(np.int32)
    lens = np.array([0, 5, 16, 24], np.int32)
    yield "gqa_partial_zero", (q, kp, vp, bt, lens)
    # MHA, one page per sequence and a shared physical page
    kp, vp = _pool(seed=3, kvh=4, pages=6, bs=4, d=16)
    rng = np.random.RandomState(4)
    q = rng.randn(3, 4, 16).astype(np.float32)
    bt = np.array([[5, 1], [1, 2], [0, 3]], np.int32)
    lens = np.array([1, 7, 8], np.int32)
    yield "mha_shared_page", (q, kp, vp, bt, lens)
    # wide GQA group (8 query heads per kv head)
    kp, vp = _pool(seed=5, kvh=1, pages=4, bs=8, d=8)
    rng = np.random.RandomState(6)
    q = rng.randn(2, 8, 8).astype(np.float32)
    bt = np.array([[3, 2], [1, 0]], np.int32)
    lens = np.array([11, 3], np.int32)
    yield "gqa8", (q, kp, vp, bt, lens)


PAGED = dict(_paged_cases())


@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_ref_matches_jax_kernel_and_xla(case):
    args = PAGED[case]
    port = pa.paged_attention_ref(*_t(*args)).numpy()
    jargs = tuple(map(jnp.asarray, args))
    kernel = np.asarray(jpa.paged_attention(*jargs))   # Pallas interpret
    xla = np.asarray(jpa.paged_attention_xla(*jargs))
    np.testing.assert_allclose(port, kernel, **PAGED_TOL)
    np.testing.assert_allclose(port, xla, **PAGED_TOL)
    lens = args[4]
    assert np.all(port[lens == 0] == 0.0)   # exact zeros, both sides


def test_paged_block_table_reuse_after_free():
    # physical pages 2, 3 remapped to a sequence with a SHORTER length:
    # rows past it hold a previous tenant's data and must be masked
    kp, vp = _pool(seed=2)
    q = np.random.RandomState(3).randn(1, 2, 32).astype(np.float32)
    bt = np.array([[2, 3]], np.int32)
    full = pa.paged_attention_ref(*_t(q, kp, vp, bt,
                                      np.array([16], np.int32)))
    short_args = (q, kp, vp, bt, np.array([3], np.int32))
    short = pa.paged_attention_ref(*_t(*short_args)).numpy()
    assert np.abs(full.numpy() - short).max() > 1e-4
    jshort = np.asarray(jpa.paged_attention(*map(jnp.asarray, short_args)))
    np.testing.assert_allclose(short, jshort, **PAGED_TOL)


@pytest.mark.parametrize(
    "lens", [[5, 8], [0, 3], [7, 8]],
    ids=["partial_and_capacity_slot", "zero", "last_slot_and_at_capacity"],
)
def test_update_pages_matches_jax(lens):
    kp, vp = _pool(seed=6, kvh=2, pages=4, bs=4, d=16)
    rng = np.random.RandomState(7)
    kn = rng.randn(2, 2, 16).astype(np.float32)
    vn = rng.randn(2, 2, 16).astype(np.float32)
    # 2 logical pages per sequence: capacity 8 tokens
    bt = np.array([[0, 1], [2, 3]], np.int32)
    lens = np.array(lens, np.int32)   # a length of 8 is at capacity
    jk, jv = jpa.update_pages(*map(jnp.asarray, (kp, vp, kn, vn, bt, lens)))
    tk, tv = _t(kp, vp)
    tbt, tlens = _t(bt, lens)
    rows = pa.rows_below_capacity(tlens, tbt, 4)
    pk, pv = pa.update_pages(tk, tv, *_t(kn, vn), tbt, tlens, rows)
    assert pk is tk and pv is tv              # written in place
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_update_pages_drops_at_capacity():
    kp, vp = _pool(seed=8, kvh=1, pages=2, bs=4, d=8)
    kn = np.ones((1, 1, 8), np.float32)
    bt = np.array([[0, 1]], np.int32)
    tk, tv = _t(kp, vp)
    tbt, tlens = _t(bt, np.array([8], np.int32))
    rows = pa.rows_below_capacity(tlens, tbt, 4)
    assert rows.numel() == 0
    pa.update_pages(tk, tv, *_t(kn, kn), tbt, tlens, rows)
    np.testing.assert_array_equal(tk.numpy(), kp)   # nothing written
    np.testing.assert_array_equal(tv.numpy(), vp)


def _qkv(seed, b, s, h, d, hkv=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv or h, d).astype(np.float32)
    v = rng.randn(b, s, hkv or h, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s,block", [(16, 8), (32, 16)])
def test_flash_ref_matches_jax_kernel(causal, s, block):
    q, k, v = _qkv(10 + s, 2, s, 2, 16)
    out, lse = fa.flash_attention_ref(*_t(q, k, v), causal=causal)
    jout = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               block_q=block, block_k=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    # logsumexp from the JAX forward kernel ([b*h, 8, s], row-replicated)
    merge = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(4, s, 16)
    _, jlse = jfa._flash_fwd(merge(q), merge(k), merge(v), 0.25, causal,
                             block, block)
    np.testing.assert_allclose(
        lse.numpy().reshape(4, s), np.asarray(jlse)[:, 0, :], **TOL
    )


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_ref_ragged_matches_math_sdpa(causal):
    # s = 13 divides no tile: the TPU kernel refuses it, the port's
    # kernel masks the tail; its plain version must equal the math form
    q, k, v = _qkv(20, 1, 13, 2, 16)
    out, lse = fa.flash_attention_ref(*_t(q, k, v), causal=causal)
    ref = jax_sdpa(*map(jnp.asarray, (q, k, v)), is_causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # lse by hand, f64
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / 4.0
    if causal:
        s = np.where(np.tril(np.ones((13, 13), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)


def test_flash_ref_gqa_reads_kv_heads_in_place():
    q, k, v = _qkv(30, 1, 9, 4, 8, hkv=2)
    out, _ = fa.flash_attention_ref(*_t(q, k, v), causal=True)
    ref = jax_sdpa(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                   jnp.repeat(jnp.asarray(v), 2, axis=2), is_causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrappers_take_plain_path_on_cpu():
    reset_launch_counts()
    args = PAGED["gqa_partial_zero"]
    torch.testing.assert_close(
        pa.paged_attention(*_t(*args)), pa.paged_attention_ref(*_t(*args)),
        rtol=0, atol=0,
    )
    q, k, v = _t(*_qkv(40, 1, 10, 2, 16))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    do = torch.ones_like(q)
    for got, want in zip(fa.flash_attention_bwd(q, k, v, out, lse, do),
                         fa.flash_attention_bwd_ref(q, k, v, out, lse, do)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(launch_counts().values()) == {0}


def test_paged_wrapper_rejects_bad_group():
    q = torch.zeros(1, 3, 8)
    kp = torch.zeros(2, 2, 4, 8)
    with pytest.raises(ValueError, match="divisible"):
        pa.paged_attention(q, kp, kp, torch.zeros(1, 1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32))


def _jax_bwd_vs_ref(causal, s, d, h, hkv, seed):
    # the JAX backward kernels in interpret mode, 16 x 16 blocks, on the
    # JAX forward's out and lse (row 0 of its [b*h, 8, s] layout); the JAX
    # kernels take one K/V head per query head, so GQA runs them on K and
    # V repeated over each group and sums dk and dv over it
    b, group = 2, h // hkv
    q, k, v = _qkv(seed, b, s, h, d, hkv=hkv)
    do = np.random.RandomState(seed + 10).randn(b, s, h, d).astype(
        np.float32)
    scale = 1.0 / d ** 0.5
    merge = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(
        b * h, s, d)
    rep = lambda x: np.repeat(x, group, axis=2)
    jq, jk, jv, jdo = map(merge, (q, rep(k), rep(v), do))
    jout, jlse = jfa._flash_fwd(jq, jk, jv, scale, causal, 16, 16)
    jdq, jdk, jdv = jfa._flash_bwd(jq, jk, jv, jout, jlse, jdo, scale,
                                   causal, 16, 16)
    split = lambda x: torch.from_numpy(np.array(x)).reshape(
        b, h, s, d).transpose(1, 2)
    lse = torch.from_numpy(np.array(jlse)[:, 0, :]).reshape(b, h, s)
    grads = fa.flash_attention_bwd_ref(
        *_t(q, k, v), split(jout), lse, torch.from_numpy(do),
        causal=causal, scale=scale,
    )
    group_sum = lambda x: np.asarray(x).reshape(b, hkv, group, s, d).sum(2)
    wants = (np.asarray(jdq).reshape(b, h, s, d), group_sum(jdk),
             group_sum(jdv))
    for got, want in zip(grads, wants):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s,d", [(32, 16), (64, 32), (32, 64), (32, 128)])
def test_flash_bwd_ref_matches_jax_kernel(causal, s, d):
    # d 64 and 128: the head dims of the wgmma backward kernels
    _jax_bwd_vs_ref(causal, s, d, 2, 2, 50 + s + d)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_bwd_ref_gqa_matches_jax_kernel(causal):
    # four query heads on two kv heads at d 64: dk and dv sum the group
    _jax_bwd_vs_ref(causal, 32, 64, 4, 2, 120)


def _grads(fn, q, k, v, do):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return (out, *torch.autograd.grad(out, leaves, do))


@pytest.mark.parametrize(
    "s,h,hkv,causal",
    [(24, 2, 2, True), (24, 4, 2, True), (13, 2, 2, True),
     (13, 4, 1, False)],
    ids=["mha", "gqa", "ragged", "gqa_ragged_full"],
)
def test_flash_function_grads_match_math_autograd(s, h, hkv, causal):
    # the Function's forward and backward (plain versions on the CPU)
    # against autograd through the port's math attention (CPU tensors
    # never reach the Function there), K/V repeated for GQA
    q, k, v = _t(*_qkv(70 + s + h, 2, s, h, 16, hkv=hkv))
    do = torch.from_numpy(
        np.random.RandomState(80 + s).randn(2, s, h, 16).astype(np.float32))

    def math(q, k, v):
        rep = h // hkv
        return port_sdpa(q, k.repeat_interleave(rep, 2),
                         v.repeat_interleave(rep, 2), is_causal=causal)

    got = _grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal),
                 q, k, v, do)
    want = _grads(math, q, k, v, do)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)


def test_flash_function_gradcheck_float64():
    rng = np.random.RandomState(90)
    q = torch.from_numpy(rng.randn(1, 5, 2, 4)).requires_grad_()
    k = torch.from_numpy(rng.randn(1, 5, 1, 4)).requires_grad_()
    v = torch.from_numpy(rng.randn(1, 5, 1, 4)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
        (q, k, v), eps=1e-6, atol=1e-7, rtol=1e-5,
    )


# the device kernel the forward wrapper picks, before the launch
@pytest.mark.parametrize("dtype,d,sq,sk,want", [
    (torch.bfloat16, 128, 1024, 1024, "wgmma"),   # the training shape
    (torch.bfloat16, 128, 2048, 2048, "wgmma"),
    (torch.bfloat16, 64, 512, 512, "wgmma"),      # GQA d 64
    (torch.bfloat16, 128, 100, 100, "wgmma"),     # ragged: masked tail
    (torch.bfloat16, 128, 7, 300, "wgmma"),       # sq != sk (full)
    (torch.bfloat16, 16, 128, 128, "mma"),
    (torch.bfloat16, 32, 128, 128, "mma"),
    (torch.bfloat16, 256, 1024, 1024, "mma"),
    (torch.bfloat16, 128, 5, 0, "mma"),           # no keys: no tensor map
    (torch.float32, 128, 1024, 1024, "fma"),
    (torch.float32, 64, 100, 100, "fma"),
    (torch.float32, 16, 8, 8, "fma"),
])
def test_fwd_variant(dtype, d, sq, sk, want):
    assert fa._fwd_variant(dtype, d, sq, sk) == want
    assert want in fa._VARIANTS


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_forward_wrapper_plain_on_cpu_at_wgmma_shapes(d):
    # bf16 at a head dim the card would run on the wgmma kernel: on the
    # CPU the wrapper still returns the plain version, launching nothing
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(41, 1, 33, 4, d, hkv=2))
    assert fa._fwd_variant(q.dtype, d, 33, 33) == "wgmma"
    reset_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert set(launch_counts().values()) == {0}
    assert variant_counts() == {}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_ref_matches_jax_kernel_at_wgmma_head_dims(causal, d):
    # the head dims of the wgmma kernel (one and two 64-wide boxes), JAX
    # forward kernel in interpret mode with 16 x 16 blocks
    q, k, v = _qkv(100 + d, 1, 32, 2, d)
    out, lse = fa.flash_attention_ref(*_t(q, k, v), causal=causal)
    jout = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               block_q=16, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    merge = lambda x: jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(2, 32, d)
    _, jlse = jfa._flash_fwd(merge(q), merge(k), merge(v), d ** -0.5,
                             causal, 16, 16)
    np.testing.assert_allclose(
        lse.numpy().reshape(2, 32), np.asarray(jlse)[:, 0, :], **TOL
    )


def test_flash_ref_ragged_gqa_at_d64_matches_math_sdpa():
    # the kernel phase's GQA d 64 case, at a ragged length (masked tail)
    q, k, v = _qkv(110, 1, 45, 8, 64, hkv=2)
    out, _ = fa.flash_attention_ref(*_t(q, k, v), causal=True)
    ref = jax_sdpa(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 4, axis=2),
                   jnp.repeat(jnp.asarray(v), 4, axis=2), is_causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# the device kernels the backward wrapper picks, before the launch
@pytest.mark.parametrize("dtype,d,sq,sk,want", [
    (torch.bfloat16, 128, 1024, 1024, "wgmma"),   # the training shape
    (torch.bfloat16, 64, 512, 512, "wgmma"),      # GQA d 64
    (torch.bfloat16, 128, 100, 100, "wgmma"),     # ragged: masked tails
    (torch.bfloat16, 64, 7, 300, "wgmma"),        # sq != sk (full)
    (torch.bfloat16, 16, 128, 128, "mma"),
    (torch.bfloat16, 32, 128, 128, "mma"),
    (torch.bfloat16, 128, 5, 0, "mma"),           # no keys: no tensor map
    (torch.bfloat16, 128, 0, 5, "mma"),           # no queries
    (torch.float32, 128, 1024, 1024, "fma"),
    (torch.float32, 64, 100, 100, "fma"),
    (torch.float32, 16, 8, 8, "fma"),
])
def test_bwd_variant(dtype, d, sq, sk, want):
    assert fa._bwd_variant(dtype, d, sq, sk) == want
    assert want in fa._VARIANTS
    assert d in fa.BWD_HEAD_DIMS


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_backward_wrapper_plain_on_cpu_at_wgmma_shapes(d, hkv):
    # bf16 at a head dim the card would run on the wgmma kernels: on the
    # CPU the wrapper returns the plain version's gradients (delta from
    # attention_delta), launching nothing
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(43, 1, 33, 4, d, hkv=hkv))
    do = torch.from_numpy(np.random.RandomState(44).randn(
        1, 33, 4, d).astype(np.float32)).to(torch.bfloat16)
    assert fa._bwd_variant(q.dtype, d, 33, 33) == "wgmma"
    reset_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    for g, w, x in zip(got, want, (q, k, v)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
    assert set(launch_counts().values()) == {0}
    assert variant_counts() == {}
