"""The port's kernel modules against the JAX package's kernels, on the CPU.

The JAX side runs as its own tests run it off-TPU: the Pallas kernels in
interpret mode (``_compat.interpret_mode()``), beside their XLA
references. The port's side is the plain PyTorch version of each kernel,
which its wrapper takes for CPU tensors (the CUDA kernels themselves run
only on the card: ``chip_smoke.py`` holds them against these plain
versions there). f32 tolerance atol 2e-5, rtol 2e-5 for the paged cases
(the JAX package's own kernel-vs-reference tolerance), atol 1e-5, rtol
1e-4 elsewhere; float16 paged attention atol and rtol 2e-3 (both sides
compute in f32 and round the output to float16, whose unit roundoff is
2^-11: one rounding apart at most). The flash backward's gradients through
``FlashAttentionFunction`` are also held to autograd through the math
attention, and to finite differences in float64.
"""
import importlib.util
from pathlib import Path

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
from paddle_tpu_torch.kernels.kv_write import kv_write_ref
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.ops import scaled_dot_product_attention as port_sdpa

PAGED_TOL = dict(atol=2e-5, rtol=2e-5)
F16_PAGED_TOL = dict(atol=2e-3, rtol=2e-3)
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


@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_ref_float16_matches_jax_xla(case):
    # float16 q and pages, the same values on both sides: the JAX package
    # serves such q through paged_attention_xla (its kernel takes f32 and
    # bf16), the port's card through its float16 kernel instance, held to
    # this plain version
    q, kp, vp, bt, lens = PAGED[case]
    args = (q.astype(np.float16), kp.astype(np.float16),
            vp.astype(np.float16), bt, lens)
    reset_launch_counts()
    port = pa.paged_attention(*_t(*args))
    assert port.dtype == torch.float16
    assert set(launch_counts().values()) == {0}
    torch.testing.assert_close(port, pa.paged_attention_ref(*_t(*args)),
                               rtol=0, atol=0)
    xla = np.asarray(jpa.paged_attention_xla(*map(jnp.asarray, args)))
    assert xla.dtype == np.float16
    np.testing.assert_allclose(port.float().numpy(), xla.astype(np.float32),
                               **F16_PAGED_TOL)
    assert np.all(port.numpy()[lens == 0] == 0.0)


F16, BF16, F32, I8 = torch.float16, torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("q_dtype,page_dtype", [
    (F16, F16), (F16, I8), (BF16, BF16), (BF16, I8), (F32, F32), (F32, I8),
])
def test_paged_variant_is_the_cluster_kernel(q_dtype, page_dtype):
    # the device kernel the wrapper launches, chosen before the launch
    assert pa._paged_variant(q_dtype, page_dtype) == "cluster"
    assert set(pa._VARIANTS) == {"cluster", "split"}
    assert q_dtype in pa._DTYPES


@pytest.mark.parametrize("q_dtype,page_dtype", [
    (F16, BF16), (BF16, F16), (F32, F16), (torch.float64, torch.float64),
])
def test_paged_variant_refuses_other_dtypes(q_dtype, page_dtype):
    with pytest.raises(TypeError, match="float16"):
        pa._paged_variant(q_dtype, page_dtype)


def test_paged_wrapper_takes_float16_on_cpu():
    # float16 CPU tensors: the plain version, whichever kernel is named
    q, kp, vp, bt, lens = PAGED["gqa_partial_zero"]
    args = _t(q.astype(np.float16), kp.astype(np.float16),
              vp.astype(np.float16), bt, lens)
    reset_launch_counts()
    for variant in (None, "cluster", "split"):
        out = pa.paged_attention(*args, variant=variant)
        assert out.dtype == torch.float16 and out.shape == args[0].shape
        torch.testing.assert_close(out, pa.paged_attention_ref(*args),
                                   rtol=0, atol=0)
    assert set(launch_counts().values()) == {0}
    assert variant_counts() == {}


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


def _with_sink(pages):
    """A pool entry with the sink page ``kernels.kv_write`` needs after
    its pages (the layout ``serving.KVPool`` allocates)."""
    return np.concatenate([pages, np.zeros_like(pages[:, :1])], axis=1)


def _decode_routing(lens):
    """kv_write's arguments for a decode step: slot b writes at its
    length, every slot valid (at-capacity rows are dropped by position)."""
    n = len(lens)
    return (np.arange(n, dtype=np.int32), np.asarray(lens, np.int32),
            np.ones(n, bool))


@pytest.mark.parametrize(
    "lens", [[5, 8], [0, 3], [7, 8]],
    ids=["partial_and_capacity_slot", "zero", "last_slot_and_at_capacity"],
)
def test_update_pages_matches_jax(lens):
    # the port's page write (kv_write_ref, decode routing) against JAX's
    # update_pages: the live pages bit-identical
    kp, vp = _pool(seed=6, kvh=2, pages=4, bs=4, d=16)
    rng = np.random.RandomState(7)
    kn = rng.randn(2, 2, 16).astype(np.float32)
    vn = rng.randn(2, 2, 16).astype(np.float32)
    # 2 logical pages per sequence: capacity 8 tokens
    bt = np.array([[0, 1], [2, 3]], np.int32)
    lens = np.array(lens, np.int32)   # a length of 8 is at capacity
    jk, jv = jpa.update_pages(*map(jnp.asarray, (kp, vp, kn, vn, bt, lens)))
    tk, tv = _t(_with_sink(kp), _with_sink(vp))
    kv_write_ref(tk, tv, *_t(kn, vn, bt, *_decode_routing(lens)))
    np.testing.assert_array_equal(tk.numpy()[:, :-1], np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy()[:, :-1], np.asarray(jv))


def test_update_pages_drops_at_capacity():
    kp, vp = _pool(seed=8, kvh=1, pages=2, bs=4, d=8)
    kn = np.ones((1, 1, 8), np.float32)
    bt = np.array([[0, 1]], np.int32)
    tk, tv = _t(_with_sink(kp), _with_sink(vp))
    kv_write_ref(tk, tv, *_t(kn, kn, bt, *_decode_routing([8])))
    np.testing.assert_array_equal(tk.numpy()[:, :-1], kp)   # nothing written
    np.testing.assert_array_equal(tv.numpy()[:, :-1], vp)


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


def _jax_bwd_vs_ref(causal, s, d, h, hkv, seed,
                    bwd=fa.flash_attention_bwd_ref):
    # the JAX backward kernels in interpret mode, 16 x 16 blocks, on the
    # JAX forward's out and lse (row 0 of its [b*h, 8, s] layout), against
    # ``bwd`` (the plain version, or an emulation of a device design); the
    # JAX kernels take one K/V head per query head, so GQA runs them on K
    # and V repeated over each group and sums dk and dv over it
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
    grads = bwd(
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
    # f32 at d 64 and 128 runs the 3xTF32 kernel (ids as before it, when
    # these cases expected the FMA kernel)
    pytest.param(torch.float32, 128, 1024, 1024, "tf32x3",
                 id="dtype9-128-1024-1024-fma"),
    pytest.param(torch.float32, 64, 100, 100, "tf32x3",
                 id="dtype10-64-100-100-fma"),
    (torch.float32, 16, 8, 8, "fma"),
    # the FMA kernel keeps the other head dims and sk == 0
    (torch.float32, 32, 128, 128, "fma"),
    (torch.float32, 256, 128, 128, "fma"),
    (torch.float32, 128, 5, 0, "fma"),
    (torch.float32, 64, 7, 300, "tf32x3"),        # sq != sk (full)
    (torch.float32, 64, 256, 256, "tf32x3"),      # the DiT shape
])
def test_fwd_variant(dtype, d, sq, sk, want):
    assert fa._fwd_variant(dtype, d, sq, sk) == want
    assert want in fa._VARIANTS


def test_fwd_variant_ids_reach_their_kernels():
    # the launch function's variant argument: 0 the dtype's own kernel
    # (FMA for f32, mma.sync for 16-bit), 1 wgmma, 2 the f32 3xTF32 kernel
    assert fa._VARIANTS == {"fma": 0, "mma": 0, "wgmma": 1, "tf32x3": 2}


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf32_parts(x):
    """The 3xTF32 kernel's split of an f32 tensor: hi rounded to TF32
    (carry into bit 13, low 13 bits cleared), lo = x - hi as the tensor
    core reads it (its low 13 bits ignored)."""
    hi = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def _tf32x3_mm(a, b, passes, chunk=None):
    """a @ b as the kernel forms it: hi x hi, plus the two cross terms
    with three passes (every product of TF32 parts is exact in f32). With
    `chunk`, hi x hi is summed `chunk` values of k at a time, each sum
    from zero, then added in f32, as the backward's S and dP products."""
    ah, al = _tf32_parts(a)
    bh, bl = _tf32_parts(b)
    if chunk is None:
        big = ah @ bh
    else:
        big = torch.zeros(())
        for c in range(0, a.shape[-1], chunk):
            big = big + ah[..., c:c + chunk] @ bh[..., c:c + chunk, :]
    if passes == 1:
        return big
    return big + (al @ bh + ah @ bl)


def _tf32x3_flash(q, k, v, causal, passes=3, tile=32):
    """The 3xTF32 forward's arithmetic in f32 on the CPU: scores of 32-key
    tiles in base-2 units, the online softmax (running max and sum), P V
    per tile added to the rescaled running output, lse = m ln 2 + ln l."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sl2 = d ** -0.5 * 1.4426950408889634
    qf, kf, vf = (x.transpose(1, 2) for x in (q, k, v))
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = _tf32x3_mm(qf, kt.transpose(-1, -2), passes) * sl2
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None]
            s = s.masked_fill(cols > rows, float("-inf"))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tf32x3_mm(p, vt, passes)
        m = mn
    out = torch.where(l == 0, torch.zeros_like(o), o / l)
    lse = m[..., 0] * 0.6931471805599453 + torch.log(
        torch.where(l == 0, torch.ones_like(l), l))[..., 0]
    return out.transpose(1, 2), lse


@pytest.mark.parametrize("b,s,h,d,causal", [
    (2, 96, 2, 64, True),
    (1, 70, 2, 128, False),      # a ragged last key tile
    (4, 64, 2, 64, False),
])
def test_tf32x3_arithmetic_meets_the_f32_gate(b, s, h, d, causal):
    # the 3xTF32 forward's split, products and tiled base-2 softmax,
    # emulated in f32: within chip_smoke's f32 gate of the plain version,
    # as close to the float64 plain version as the f32 plain version is
    # (within F32_DESIGN_F64_RATIO of it, the card's bound), and lse
    # within 1e-3. One pass (hi x hi only) fails the gate: the planted
    # copy the card must reject.
    cs = _chip_smoke()
    q, k, v = _t(*_qkv(50 + d, b, s, h, d))
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=causal)
    ref64 = fa.flash_attention_ref(q.double(), k.double(), v.double(),
                                   causal=causal)[0]
    out, lse = _tf32x3_flash(q, k, v, causal)
    ok, stats = cs.compare(out, ref)
    assert ok, stats
    assert (lse - ref_lse).abs().max().item() <= 1e-3

    def f64_err(x):
        return ((x.double() - ref64).norm() / ref64.norm()).item()

    assert f64_err(out) <= cs.F32_DESIGN_F64_RATIO * f64_err(ref)
    one_pass, _ = _tf32x3_flash(q, k, v, causal, passes=1)
    ok, stats = cs.compare(one_pass, ref)
    assert not ok and stats["rel_l2"] > cs.GATE["float32"]["l2"], stats


def _tf32x3_flash_bwd(q, k, v, out, lse, do, *, causal, scale=None,
                      passes=3):
    """The 3xTF32 backward's arithmetic in f32 on the CPU, on the
    forward's out and lse, in the kernels' tiles (32 rows at d 64, 16 at
    d 128): S and dP of each tile in 3xTF32, hi x hi summed 32 values of
    d at a time, P = exp(S scale - lse), dS = P (dP - delta) scale; dq
    summed from per-key-tile partials dS K, dk and dv from per-query-tile
    partials dS^T Q and P^T dO (each partial product in 3xTF32), GQA
    summed over the group."""
    b, sq, h, d = q.shape
    tile = 16 if d == 128 else 32
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if scale is None else scale
    qf, dof = (x.transpose(1, 2) for x in (q, do))        # [b, h, s, d]
    kf, vf = (x.transpose(1, 2).repeat_interleave(group, dim=1)
              for x in (k, v))
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)[..., None]
    delta = fa.attention_delta(out, do)[..., None]

    def p_ds(qt, dot, kt, vt, lt, dlt, rows, cols):
        p = torch.exp(_tf32x3_mm(qt, kt.transpose(-1, -2), passes, 32)
                      * scale - lt)
        if causal:
            p = p.masked_fill(cols > rows, 0.0)
        dp = _tf32x3_mm(dot, vt.transpose(-1, -2), passes, 32)
        return p, p * (dp - dlt) * scale

    dq = torch.zeros_like(qf)
    for k0 in range(0, sk, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        _, ds = p_ds(qf, dof, kt, vt, lse, delta, torch.arange(sq)[:, None],
                     torch.arange(k0, k0 + kt.shape[2])[None])
        dq = dq + _tf32x3_mm(ds, kt, passes)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, sq, tile):
        rows = slice(q0, q0 + tile)
        qt, dot = qf[:, :, rows], dof[:, :, rows]
        p, ds = p_ds(qt, dot, kf, vf, lse[:, :, rows], delta[:, :, rows],
                     torch.arange(q0, q0 + qt.shape[2])[:, None],
                     torch.arange(sk)[None])
        dv = dv + _tf32x3_mm(p.transpose(-1, -2), dot, passes)
        dk = dk + _tf32x3_mm(ds.transpose(-1, -2), qt, passes)
    dk, dv = (x.view(b, hkv, group, sk, d).sum(2) for x in (dk, dv))
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


@pytest.mark.parametrize("b,s,h,hkv,d,causal", [
    (2, 96, 2, 2, 64, True),
    (1, 70, 2, 2, 128, False),   # a ragged last tile
    (1, 64, 4, 2, 64, True),     # GQA 4 -> 2
    (1, 45, 4, 2, 128, True),    # GQA, ragged
    (2, 64, 2, 2, 64, False),
])
def test_tf32x3_bwd_arithmetic_meets_the_f32_gate(b, s, h, hkv, d, causal):
    # the 3xTF32 backward's split products and per-tile partial sums,
    # emulated in f32 on the plain forward's out and lse: every gradient
    # within chip_smoke's f32 gate of the plain version and as close to
    # the float64 plain version as the f32 plain version is (within
    # F32_DESIGN_F64_RATIO of it, the card's bound). One pass (hi x hi
    # only) fails the gate in every gradient: the planted copy the card
    # must reject.
    cs = _chip_smoke()
    q, k, v = _t(*_qkv(60 + d, b, s, h, d, hkv=hkv))
    do = torch.from_numpy(np.random.RandomState(61 + d).randn(
        b, s, h, d).astype(np.float32))
    out, lse = fa.flash_attention_ref(q, k, v, causal=causal)
    refs = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    refs64 = fa.flash_attention_bwd_ref(
        *(x.double() for x in (q, k, v, out, lse, do)), causal=causal)
    got = _tf32x3_flash_bwd(q, k, v, out, lse, do, causal=causal)

    def f64_err(x, r64):
        return ((x.double() - r64).norm() / r64.norm()).item()

    for x, ref, ref64 in zip(got, refs, refs64):
        ok, stats = cs.compare(x, ref)
        assert ok, stats
        assert f64_err(x, ref64) <= (cs.F32_DESIGN_F64_RATIO
                                     * f64_err(ref, ref64))
    one_pass = _tf32x3_flash_bwd(q, k, v, out, lse, do, causal=causal,
                                 passes=1)
    for x, ref in zip(one_pass, refs):
        ok, stats = cs.compare(x, ref)
        assert not ok and stats["rel_l2"] > cs.GATE["float32"]["l2"], stats


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_tf32x3_bwd_emulation_matches_jax_kernel(d):
    # the emulated 3xTF32 gradients against the JAX backward kernels in
    # interpret mode (GQA 4 -> 2, causal), at the file's tolerance
    _jax_bwd_vs_ref(True, 32, d, 4, 2, 130 + d, bwd=_tf32x3_flash_bwd)


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_f32_backward_wrapper_plain_on_cpu_at_tf32x3_shapes(d, hkv):
    # f32 at a head dim the card would run on the 3xTF32 kernels: on the
    # CPU the backward wrapper returns the plain version's gradients,
    # launching nothing
    q, k, v = _t(*_qkv(47, 1, 33, 4, d, hkv=hkv))
    do = torch.from_numpy(np.random.RandomState(48).randn(
        1, 33, 4, d).astype(np.float32))
    assert fa._bwd_variant(q.dtype, d, 33, 33) == "tf32x3"
    reset_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    for g, w, x in zip(got, want, (q, k, v)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert g.dtype == torch.float32 and g.shape == x.shape
    assert set(launch_counts().values()) == {0}
    assert variant_counts() == {}


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_f32_forward_wrapper_plain_on_cpu_at_tf32x3_shapes(d):
    # f32 at a head dim the card would run on the 3xTF32 kernel: on the
    # CPU the wrapper still returns the plain version, launching nothing
    q, k, v = _t(*_qkv(45, 1, 33, 4, d, hkv=2))
    assert fa._fwd_variant(q.dtype, d, 33, 33) == "tf32x3"
    reset_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert set(launch_counts().values()) == {0}
    assert variant_counts() == {}


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
    # f32 at d 64 and 128 runs the 3xTF32 kernels (ids as before them,
    # when these cases expected the FMA kernels)
    pytest.param(torch.float32, 128, 1024, 1024, "tf32x3",
                 id="dtype8-128-1024-1024-fma"),
    pytest.param(torch.float32, 64, 100, 100, "tf32x3",
                 id="dtype9-64-100-100-fma"),
    (torch.float32, 16, 8, 8, "fma"),
    # the FMA kernels keep d 16 and 32 and the empty lengths
    (torch.float32, 32, 128, 128, "fma"),
    pytest.param(torch.float32, 64, 256, 256, "tf32x3",   # the DiT shape
                 id="dtype12-64-256-256-fma"),
    pytest.param(torch.float32, 128, 7, 300, "tf32x3",    # sq != sk (full)
                 id="dtype13-128-7-300-fma"),
    (torch.float32, 64, 5, 0, "fma"),
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
