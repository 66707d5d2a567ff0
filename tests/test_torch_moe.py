"""The port's MoE family against the JAX package's, on the CPU.

Same numpy inputs (and, for layers and models, the JAX package's seeded
weights loaded through numpy) on both sides. The JAX grouped GEMM runs in
interpret mode (``impl="pallas"``, as ``tests/test_pallas_kernels.py``
runs it) and through its XLA reference ``grouped_matmul_xla``; the port
runs its plain versions, which its wrappers take for CPU tensors (the
CUDA kernels are held to them on the card by ``chip_smoke.py``).
Tolerances:

* routing ops: integers exact, floats rtol 1e-6; the port's aux loss is
  bit-identical between its dense and ragged paths;
* ``grouped_matmul_ref`` over the JAX sweeps: f32 rtol 1e-5 (atol 1e-5),
  int8 rtol 1e-4 (atol 1e-4), the JAX tests' own bounds;
* gradients of ``GroupedMatmulFunction`` against JAX's custom VJP: f32
  rtol 1e-5, atol 1e-5 (the gradients reach ~15: sums of 24-40 products
  taken in another order);
* ``MoELayer`` forward and gradients, dense and ragged: f32 rtol 1e-5
  (atol 1e-6);
* ``quantize_moe_experts``: int8 bit-identical, scales rtol 1e-6;
* a tiny 4-expert Llama: logits, loss with aux and every parameter's
  gradient within atol 1e-5, rtol 1e-4 (the port's Llama tolerance),
  greedy ``generate`` tokens identical.

On the CPU the plain int8 grouped GEMM stays differentiable, as
``grouped_matmul_xla`` is in JAX; that the int8 path refuses gradients on
the card is checked by ``chip_smoke.py``'s moe phase.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops as JF
from paddle_tpu import quantization as JQ
from paddle_tpu.incubate import MoELayer as JaxMoELayer
from paddle_tpu.incubate import TopKGate as JaxTopKGate
from paddle_tpu.kernels.pallas import grouped_matmul as jgmm
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import ops as TF
from paddle_tpu_torch.incubate import MoELayer, TopKGate
from paddle_tpu_torch.kernels import (
    launch_counts,
    reset_launch_counts,
    variant_counts,
)
from paddle_tpu_torch.kernels import grouped_matmul as gmm
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.quantization import (
    quantize_moe_experts,
    weight_quantize_grouped,
)

F_TOL = dict(rtol=1e-6, atol=1e-7)
GMM_TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
GMM_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    return t.detach().numpy()


def _routing_inputs(seed, s=24, m=8, e=4, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(s, m).astype(np.float32)
    logits = rng.randn(s, e).astype(np.float32)
    if ties:
        # equal logits: top-k must pick the lower expert index first
        logits[::3] = 0.5
        logits[1::3, :2] = 2.0
    return x, logits


# ------------------------------------------------------------ routing ops
@pytest.mark.parametrize("capacity", [0, 4, 100],
                         ids=["default", "drops", "roomy"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_gate_dispatch_and_combine_match_jax(capacity, ties):
    x, logits = _routing_inputs(1, ties=ties)
    got = TF.moe_gate_dispatch(torch.from_numpy(x),
                               torch.from_numpy(logits), k=2,
                               capacity=capacity)
    want = JF.moe_gate_dispatch(paddle.to_tensor(x),
                                paddle.to_tensor(logits), k=2,
                                capacity=capacity)
    disp, cw, eids, slots, aux, nd = got
    jdisp, jcw, jeids, jslots, jaux, jnd = (w.numpy() for w in want)
    np.testing.assert_array_equal(_np(eids), jeids)
    np.testing.assert_array_equal(_np(slots), jslots)
    assert int(nd) == int(jnd)
    if capacity == 4:
        assert int(nd) > 0
    np.testing.assert_allclose(_np(disp), jdisp, **F_TOL)
    np.testing.assert_allclose(_np(cw), jcw, **F_TOL)
    np.testing.assert_allclose(_np(aux), jaux, **F_TOL)
    y = np.random.RandomState(2).randn(*jdisp.shape).astype(np.float32)
    out = TF.moe_combine(torch.from_numpy(y), cw, eids, slots)
    jout = JF.moe_combine(paddle.to_tensor(y), *want[1:4]).numpy()
    np.testing.assert_allclose(_np(out), jout, **F_TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_ragged_dispatch_and_combine_match_jax(k, ties):
    x, logits = _routing_inputs(3, ties=ties)
    tx, tl = torch.from_numpy(x), torch.from_numpy(logits)
    xs, gs, order, cw, eids, aux = TF.moe_ragged_dispatch(tx, tl, k=k)
    jxs, jgs, jorder, jcw, jeids, jaux = (
        w.numpy() for w in JF.moe_ragged_dispatch(
            paddle.to_tensor(x), paddle.to_tensor(logits), k=k))
    np.testing.assert_array_equal(_np(order), jorder)
    np.testing.assert_array_equal(_np(gs), jgs)
    np.testing.assert_array_equal(_np(eids), jeids)
    np.testing.assert_array_equal(_np(xs), jxs)
    np.testing.assert_allclose(_np(cw), jcw, **F_TOL)
    np.testing.assert_allclose(_np(aux), jaux, **F_TOL)
    # the aux loss is bit-identical to the port's dense path
    dense_aux = TF.moe_gate_dispatch(tx, tl, k=k)[4]
    assert _np(aux).tobytes() == _np(dense_aux).tobytes()
    y = np.random.RandomState(4).randn(*jxs.shape).astype(np.float32)
    out = TF.moe_ragged_combine(torch.from_numpy(y), order, cw)
    jout = JF.moe_ragged_combine(paddle.to_tensor(y),
                                 paddle.to_tensor(jorder),
                                 paddle.to_tensor(jcw)).numpy()
    np.testing.assert_allclose(_np(out), jout, **F_TOL)


# ------------------------------------------------------------ grouped GEMM
SWEEP = [[5, 0, 11, 16], [0, 0, 32, 0], [1, 1, 1, 29], [32, 0, 0, 0],
         [0, 7, 1, 24]]


def _gmm_case(gs, seed=0, k=24, m=40):
    rng = np.random.RandomState(seed)
    lhs = rng.randn(sum(gs), k).astype(np.float32)
    rhs = rng.randn(len(gs), k, m).astype(np.float32)
    return lhs, rhs, np.array(gs, np.int32)


def _int8(rhs):
    scales = np.maximum(np.abs(rhs).max(axis=1), 1e-8) / 127.0
    q = np.clip(np.round(rhs / scales[:, None, :]), -127, 127)
    return q.astype(np.int8), scales.astype(np.float32)


@pytest.mark.parametrize("gs", SWEEP + [[3, 2, 5, 1]],
                         ids=[str(g) for g in SWEEP] + ["tile_misaligned"])
def test_grouped_matmul_ref_matches_jax(gs):
    k, m = (12, 10) if gs == [3, 2, 5, 1] else (24, 40)
    lhs, rhs, gsa = _gmm_case(gs, k=k, m=m)
    reset_launch_counts()
    out = _np(gmm.grouped_matmul(*map(torch.from_numpy, (lhs, rhs, gsa))))
    assert set(launch_counts().values()) == {0}
    jargs = tuple(map(jnp.asarray, (lhs, rhs, gsa)))
    np.testing.assert_allclose(
        out, np.asarray(jgmm.grouped_matmul_xla(*jargs)), **GMM_TOL)
    np.testing.assert_allclose(
        out, np.asarray(jgmm.grouped_matmul(*jargs, impl="pallas")),
        **GMM_TOL)
    # int8 rhs with per-channel scales
    q, sc = _int8(rhs)
    out8 = _np(gmm.grouped_matmul(*map(torch.from_numpy,
                                       (lhs, q, gsa, sc))))
    jq = (jargs[0], jnp.asarray(q), jargs[2])
    np.testing.assert_allclose(out8, np.asarray(jgmm.grouped_matmul_xla(
        *jq, jnp.asarray(sc))), **INT8_TOL)
    np.testing.assert_allclose(out8, np.asarray(jgmm.grouped_matmul(
        *jq, rhs_scales=jnp.asarray(sc), impl="pallas")), **INT8_TOL)


@pytest.mark.parametrize("gs", [[5, 0, 11, 16], [0, 7, 1, 24]])
def test_grouped_matmul_grads_match_jax_custom_vjp(gs):
    lhs, rhs, gsa = _gmm_case(gs, seed=2)
    g = np.random.RandomState(5).randn(sum(gs), 40).astype(np.float32)

    def jloss(a, b):
        out = jgmm.grouped_matmul(a, b, jnp.asarray(gsa), impl="pallas")
        return (out * jnp.asarray(g)).sum()

    jdl, jdr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lhs),
                                               jnp.asarray(rhs))
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    out = gmm.grouped_matmul(tl, tr, torch.from_numpy(gsa))
    # the gradient is the grouped GEMM op's registered autograd
    assert "paddle_tpu_torch_grouped_matmul" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_np(tl.grad), np.asarray(jdl), **GMM_GRAD_TOL)
    np.testing.assert_allclose(_np(tr.grad), np.asarray(jdr), **GMM_GRAD_TOL)


def test_grouped_matmul_function_gradcheck_float64():
    rng = np.random.RandomState(6)
    lhs = torch.from_numpy(rng.randn(7, 3)).requires_grad_()
    rhs = torch.from_numpy(rng.randn(3, 3, 2)).requires_grad_()
    gs = torch.tensor([2, 0, 5], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b: gmm.grouped_matmul(a, b, gs), (lhs, rhs),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_grouped_matmul_checks_shapes():
    lhs, rhs, gsa = _gmm_case([4, 4])
    with pytest.raises(ValueError, match="group_sizes"):
        gmm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                           torch.tensor([8], dtype=torch.int32))
    with pytest.raises(ValueError, match="rhs_scales"):
        gmm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                           torch.from_numpy(gsa), torch.ones(2, 3))


# the device kernel the grouped GEMM wrapper picks, before the launch
BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("lhs,rhs,n,k,m,want", [
    (BF, BF, 16384, 1024, 2816, "wgmma"),   # the MoE layer's up projection
    (BF, BF, 16384, 2816, 1024, "wgmma"),   # and down
    (BF, BF, 512, 1024, 256, "wgmma"),      # 2^27 multiply-adds
    (BF, BF, 1024, 32, 1024, "wgmma"),      # exactly 2^25
    (BF, BF, 1023, 32, 1024, "mma"),        # one row fewer: latency-bound
    (BF, BF, 506, 136, 200, "mma"),
    (BF, BF, 32, 24, 40, "mma"),            # the JAX sweeps
    (BF, BF, 16384, 0, 2816, "mma"),        # k == 0: zeros, no ring
    (BF, I8, 16384, 1024, 2816, "wgmma"),   # int8 rhs: the int8 wgmma
    (BF, I8, 32, 24, 40, "mma"),
    (F32, F32, 16384, 1024, 2816, "fma"),
    (F32, I8, 32, 24, 40, "fma"),
    (F32, F32, 7, 3, 5, "fma"),             # f32 takes any k and m
])
def test_gmm_variant(lhs, rhs, n, k, m, want):
    assert gmm._gmm_variant(lhs, rhs, n, k, m) == want
    assert want in gmm._VARIANTS


F16 = torch.float16


@pytest.mark.parametrize("lhs,rhs,n,k,m,groups,want", [
    (F16, F16, 16384, 1024, 2816, 8, "wgmma"),   # float16 MoE up projection
    (F16, F16, 1024, 32, 1024, 8, "wgmma"),      # exactly 2^25
    (F16, F16, 1023, 32, 1024, 8, "mma"),        # below the crossover
    (F16, F16, 32, 24, 40, 4, "mma"),            # the JAX sweeps
    (F16, F16, 16384, 0, 2816, 8, "mma"),        # k == 0
    (BF, I8, 16384, 2816, 1024, 8, "wgmma"),     # int8 down projection
    (F16, I8, 16384, 1024, 2816, 8, "wgmma"),    # float16 lhs, int8 rhs
    (F16, I8, 1024, 32, 1024, 8, "wgmma"),       # int8 at its crossover
    (F16, I8, 1023, 32, 1024, 8, "mma"),         # and one row below
    (BF, I8, 32, 24, 48, 4, "mma"),              # the JAX sweeps' size
    (BF, I8, 16384, 1024, 2808, 8, "mma"),       # m % 16 != 0: no int8 map
    (BF, I8, 16384, 1024, 2816, 129, "mma"),     # past its work-list room
    (BF, I8, 16384, 1024, 2816, 128, "wgmma"),
    (F32, I8, 16384, 1024, 2816, 8, "fma"),
])
def test_gmm_variant_float16_and_int8_crossover(lhs, rhs, n, k, m, groups,
                                                want):
    assert gmm._gmm_variant(lhs, rhs, n, k, m, groups) == want
    assert want in gmm._VARIANTS
    if rhs == I8 and lhs != F32:
        macs = n * k * m
        assert (want == "wgmma") == (
            macs >= gmm.INT8_WGMMA_MIN_MACS and m % 16 == 0
            and groups <= gmm.INT8_WGMMA_MAX_GROUPS)


# float16 against the JAX reference: both sides take the same float16
# inputs, accumulate in f32 and round the output to float16 (unit
# roundoff 2^-11): one rounding apart, rtol and atol 2e-3
F16_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("gs", SWEEP, ids=[str(g) for g in SWEEP])
def test_grouped_matmul_ref_float16_matches_jax(gs):
    lhs, rhs, gsa = _gmm_case(gs, seed=11)
    lhs16, rhs16 = lhs.astype(np.float16), rhs.astype(np.float16)
    reset_launch_counts()
    out = gmm.grouped_matmul(*map(torch.from_numpy, (lhs16, rhs16, gsa)))
    assert out.dtype == torch.float16
    assert set(launch_counts().values()) == {0}
    want = np.asarray(jgmm.grouped_matmul_xla(
        *map(jnp.asarray, (lhs16, rhs16, gsa))))
    assert want.dtype == np.float16
    np.testing.assert_allclose(_np(out), want.astype(np.float32), **F16_TOL)
    # int8 rhs with per-channel scales and float16 lhs
    q, sc = _int8(rhs)
    out8 = gmm.grouped_matmul(*map(torch.from_numpy, (lhs16, q, gsa, sc)))
    assert out8.dtype == torch.float16
    want8 = np.asarray(jgmm.grouped_matmul_xla(
        *map(jnp.asarray, (lhs16, q, gsa)), jnp.asarray(sc)))
    np.testing.assert_allclose(_np(out8), want8.astype(np.float32),
                               **F16_TOL)


def test_grouped_matmul_plain_on_cpu_takes_float16():
    # float16 at a shape the card runs on the wgmma kernels: the CPU
    # wrapper returns the plain version, float and int8 rhs alike
    rng = np.random.RandomState(12)
    gs = torch.tensor([300, 0, 500, 224], dtype=torch.int32)
    lhs = torch.from_numpy(rng.randn(1024, 32).astype(np.float16))
    rhs = torch.from_numpy(rng.randn(4, 32, 1024).astype(np.float32))
    q, sc = map(torch.from_numpy, _int8(rhs.numpy()))
    reset_launch_counts()
    for args in ((lhs, rhs.half(), gs), (lhs, q, gs, sc)):
        assert gmm._gmm_variant(lhs.dtype, args[1].dtype, 1024, 32,
                                1024) == "wgmma"
        with torch.no_grad():
            out = gmm.grouped_matmul(*args)
        torch.testing.assert_close(out, gmm.grouped_matmul_ref(*args),
                                   rtol=0, atol=0)
        assert out.dtype == F16 and out.shape == (1024, 1024)
    assert set(launch_counts().values()) == {0}
    assert variant_counts() == {}


def test_grouped_matmul_plain_on_cpu_at_a_wgmma_shape():
    # bf16 at a shape the card would run on the wgmma kernel: the CPU
    # wrapper returns the plain version and launches nothing
    rng = np.random.RandomState(8)
    gs = torch.tensor([300, 0, 500, 224], dtype=torch.int32)
    lhs = torch.from_numpy(rng.randn(1024, 32).astype(np.float32)).to(BF)
    rhs = torch.from_numpy(rng.randn(4, 32, 1024).astype(np.float32)).to(BF)
    assert gmm._gmm_variant(lhs.dtype, rhs.dtype, 1024, 32, 1024) == "wgmma"
    reset_launch_counts()
    out = gmm.grouped_matmul(lhs, rhs, gs)
    torch.testing.assert_close(out, gmm.grouped_matmul_ref(lhs, rhs, gs),
                               rtol=0, atol=0)
    assert out.dtype == BF and out.shape == (1024, 1024)
    assert set(launch_counts().values()) == {0}
    assert variant_counts() == {}


@pytest.mark.parametrize("gs", [[0, 37, 0, 90], [45, 0, 83, 0]],
                         ids=["ragged_n", "empty_groups"])
def test_grouped_matmul_ref_matches_jax_at_wgmma_box_widths(gs):
    # k 64 and m 128: one k box and two 64-column boxes of the wgmma
    # kernel's tile; n = 127 and 128 rows with empty leading, interior
    # and trailing groups
    lhs, rhs, gsa = _gmm_case(gs, seed=9, k=64, m=128)
    out = _np(gmm.grouped_matmul(*map(torch.from_numpy, (lhs, rhs, gsa))))
    jargs = tuple(map(jnp.asarray, (lhs, rhs, gsa)))
    np.testing.assert_allclose(
        out, np.asarray(jgmm.grouped_matmul_xla(*jargs)), **GMM_TOL)
    np.testing.assert_allclose(
        out, np.asarray(jgmm.grouped_matmul(*jargs, impl="pallas")),
        **GMM_TOL)


# ---------------------------------------------------------------- layer
def _layers(impl="dense", cap=1.25, seed=0, d=16, e=4, f=32, k=2):
    paddle.seed(seed)
    jax_layer = JaxMoELayer(d_model=d, num_experts=e, d_ff=f, k=k,
                            capacity_factor=cap, impl=impl)
    port = MoELayer(d, e, f, k=k, capacity_factor=cap, impl=impl,
                    device="cpu")
    port.load_state_dict({n: torch.from_numpy(np.asarray(p.numpy()))
                          for n, p in jax_layer.state_dict().items()})
    return jax_layer, port


@pytest.mark.parametrize("impl,cap", [("dense", 1.25), ("dense", 0.6),
                                      ("dense", 8.0), ("ragged", 1.25)],
                         ids=["dense", "dense_drops", "dense_roomy",
                              "ragged"])
def test_moe_layer_forward_and_grads_match_jax(impl, cap):
    jax_layer, port = _layers(impl, cap)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 16).astype(np.float32)
    w = rng.randn(2, 12, 16).astype(np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout, jaux, jstats = jax_layer(jx, return_stats=True)
    ((jout * paddle.to_tensor(w)).sum() + jaux).backward()
    tx = torch.from_numpy(x).requires_grad_()
    out, aux, stats = port(tx, return_stats=True)
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(_np(out), jout.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(_np(aux), jaux.numpy(), **F_TOL)
    assert int(stats["dropped_assignments"]) == int(
        np.asarray(jstats["dropped_assignments"].numpy()
                   if hasattr(jstats["dropped_assignments"], "numpy")
                   else jstats["dropped_assignments"]))
    assert stats["capacity"] == jstats["capacity"]
    if cap == 0.6:
        assert int(stats["dropped_assignments"]) > 0
    np.testing.assert_allclose(_np(tx.grad), jx.grad.numpy(), **GRAD_TOL)
    jgrads = dict(jax_layer.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(_np(p.grad), jgrads[name].grad.numpy(),
                                   **GRAD_TOL, err_msg=name)


def test_ragged_matches_dense_and_aux_bit_identical():
    # capacity e / k: the dense path can drop nothing, so both compute
    # the same math; the aux loss is one expression
    _, dense = _layers("dense", cap=2.0)
    _, ragged = _layers("ragged")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 10, 16).astype(
        np.float32))
    od, ad, sd = dense(x, return_stats=True)
    orr, ar = ragged(x)
    assert int(sd["dropped_assignments"]) == 0
    np.testing.assert_allclose(_np(orr), _np(od), **GRAD_TOL)
    assert _np(ar).tobytes() == _np(ad).tobytes()


def test_custom_gate_keeps_dense_contract():
    calls = []

    class MyGate(TopKGate):
        def forward(self, x):
            calls.append(1)
            return super().forward(x)

    class JaxGate(JaxTopKGate):
        pass

    paddle.seed(0)
    jgate = JaxGate(8, 2, k=2, capacity_factor=4.0)
    jax_layer = JaxMoELayer(d_model=8, num_experts=2, d_ff=16, gate=jgate)
    port = MoELayer(8, 2, 16, gate=MyGate(8, 2, k=2, capacity_factor=4.0,
                                          device="cpu"), device="cpu")
    port.load_state_dict({n: torch.from_numpy(np.asarray(p.numpy()))
                          for n, p in jax_layer.state_dict().items()})
    x = np.random.RandomState(5).randn(1, 6, 8).astype(np.float32)
    out, aux = port(torch.from_numpy(x))
    jout, jaux = jax_layer(paddle.to_tensor(x))
    assert calls
    np.testing.assert_allclose(_np(out), jout.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(_np(aux), jaux.numpy(), **F_TOL)
    with pytest.raises(ValueError, match="TopKGate"):
        MoELayer(8, 2, 16, gate=MyGate(8, 2, device="cpu"), impl="ragged",
                 device="cpu")
    with pytest.raises(ValueError, match="impl"):
        MoELayer(8, 2, impl="sparse", device="cpu")


def test_quantize_moe_experts_matches_jax():
    jax_layer, port = _layers("ragged")
    w = np.random.RandomState(8).randn(4, 16, 32).astype(np.float32)
    q, s = weight_quantize_grouped(torch.from_numpy(w))
    jq, js = JQ.weight_quantize_grouped(paddle.to_tensor(w))
    np.testing.assert_array_equal(_np(q), jq.numpy())
    np.testing.assert_allclose(_np(s), js.numpy(), rtol=1e-6, atol=0)
    x = np.random.RandomState(3).randn(2, 8, 16).astype(np.float32)
    float_out = _np(port(torch.from_numpy(x))[0])
    saved = quantize_moe_experts(port)
    assert saved == JQ.quantize_moe_experts(jax_layer)
    jstate = jax_layer.state_dict()
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            _np(getattr(port.experts, name)),
            jstate[f"experts.{name}"].numpy())
        np.testing.assert_allclose(
            _np(getattr(port.experts, f"{name}_scale")),
            jstate[f"experts.{name}_scale"].numpy(), rtol=1e-6, atol=0)
    assert port.experts.quantized and not port.experts.w_up.requires_grad
    with torch.no_grad():
        out = _np(port(torch.from_numpy(x))[0])
    jout = jax_layer(paddle.to_tensor(x))[0].numpy()
    np.testing.assert_allclose(out, jout, **INT8_TOL)
    err = np.abs(out - float_out).max() / np.abs(float_out).max()
    assert err < 0.05, err
    assert any(k.endswith("_scale") for k in port.state_dict())
    with pytest.raises(RuntimeError, match="ragged"):
        port.experts(torch.zeros(4, 2, 16))


# ---------------------------------------------------------------- Llama
LLAMA = {"mha": {}, "gqa": {"num_key_value_heads": 2}}


def _llama(variant, **over):
    cfg = dict(LLAMA[variant], num_experts=4, **over)
    paddle.seed(0)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(**cfg))
    port = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_reference_state(
        port, {k: v.numpy() for k, v in jax_model.state_dict().items()})
    return jax_model, port


@pytest.fixture(scope="module", params=sorted(LLAMA))
def llama(request):
    return _llama(request.param)


def test_moe_llama_logits_match(llama):
    jax_model, port = llama
    ids = np.random.RandomState(0).randint(1, 128, (2, 11)).astype("int64")
    with torch.no_grad():
        out = _np(port(torch.from_numpy(ids)))
    np.testing.assert_allclose(out, jax_model(paddle.to_tensor(ids)).numpy(),
                               **LLAMA_TOL)


@pytest.mark.parametrize("chunk", [0, 16], ids=["logits", "fused16"])
def test_moe_llama_loss_and_grads_match(llama, chunk):
    jax_model, port = llama
    for cfg in (jax_model.config, port.config):
        cfg.fused_loss_chunk = chunk
    ids = np.random.RandomState(4).randint(1, 128, (2, 12)).astype(np.int64)
    for p in jax_model.parameters():
        p.grad = None
    _, jloss = jax_model(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jloss.backward()
    port.zero_grad(set_to_none=True)
    _, loss = port(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(_np(loss), jloss.numpy(), **LLAMA_TOL)
    # the aux term is in the loss: without it the loss differs
    hidden, aux = port.llama(torch.from_numpy(ids))
    assert aux.item() > 0
    jgrads = dict(jax_model.named_parameters())
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in port.named_parameters():
        want = jgrads[name].grad.numpy()
        np.testing.assert_allclose(
            _np(p.grad), want.T if name in linear else want, **LLAMA_TOL,
            err_msg=name)


def test_moe_llama_greedy_generate_identical(llama):
    jax_model, port = llama
    ids = np.random.RandomState(5).randint(1, 128, (2, 6)).astype("int64")
    ref = jax_model.generate(paddle.to_tensor(ids), max_new_tokens=5).numpy()
    out = port.generate(torch.from_numpy(ids), max_new_tokens=5)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_moe_llama_recompute_same_loss():
    _, port = _llama("mha")
    ids = torch.from_numpy(
        np.random.RandomState(6).randint(1, 128, (2, 9)).astype(np.int64))
    _, loss = port(ids, labels=ids)
    port.config.recompute = True
    _, loss_rc = port(ids, labels=ids)
    loss_rc.backward()
    assert loss_rc.item() == loss.item()
    assert all(p.grad is not None for p in port.parameters())
