"""MoE training in the port against the JAX package, on the CPU.

* The grouped GEMM's weight gradient: ``grouped_matmul_wgrad`` (on CPU
  tensors its plain version ``_segment_outer``; the CUDA kernel is held to
  it on the card by ``chip_smoke.py``) against the ``drhs`` of
  ``jax.vjp`` of the JAX fallback ``grouped_matmul_xla``, over empty,
  1-row and tile-unaligned groups: f32 within rtol 1e-5 (atol 1e-5: sums
  of up to 50 products in another order), bf16 within rtol 1e-2 (atol
  1e-2: both round the f32 sum to bf16, at most an ulp apart).
* A ragged ``MoELayer`` trained two AdamW steps beside the JAX layer:
  loss, every parameter and every AdamW moment within rtol 1e-5 (atol
  1e-6).
* A tiny 4-expert Llama through ``jit.TrainStep`` against JAX's
  ``TrainStep``: the losses of three steps and the weights after them,
  and the first step's gradients, within the port's Llama tolerance
  (rtol 1e-4, atol 1e-5).
* The wrapper refuses mismatched shapes, dtypes and devices by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import MoELayer as JaxMoELayer
from paddle_tpu.kernels.pallas import grouped_matmul as jgmm
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.incubate import MoELayer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels import grouped_matmul as gmm
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
LLAMA_TOL = dict(rtol=1e-4, atol=1e-5)

GROUPS = {
    "empty_and_one_row": [0, 1, 5, 0, 9, 1],
    "one_row_each": [1, 1, 1, 29],
    "unaligned": [37, 0, 50, 13],
    "all_empty": [0, 0, 0],
}


def _jax_drhs(lhs, g, gs, m, dtype):
    """drhs of the JAX fallback's VJP (the JAX custom VJP's source)."""
    rhs = jnp.zeros((len(gs), lhs.shape[1], m), dtype)
    _, vjp = jax.vjp(lambda a, b: jgmm.grouped_matmul_xla(
        a, b, jnp.asarray(gs)), jnp.asarray(lhs, dtype), rhs)
    return np.asarray(vjp(jnp.asarray(g, dtype))[1].astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_weight_gradient_matches_jax_vjp(case, dtype):
    gs = np.array(GROUPS[case], np.int32)
    n, k, m = int(gs.sum()), 24, 40
    rng = np.random.RandomState(3)
    lhs = rng.randn(n, k).astype(np.float32)
    g = rng.randn(n, m).astype(np.float32)
    want = _jax_drhs(lhs, g, gs, m, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    reset_launch_counts()
    got = gmm.grouped_matmul_wgrad(torch.from_numpy(lhs).to(tdt),
                                   torch.from_numpy(g).to(tdt),
                                   torch.from_numpy(gs), len(gs))
    assert set(launch_counts().values()) == {0}
    assert got.dtype == tdt and got.shape == (len(gs), k, m)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))
    for i in np.flatnonzero(gs == 0):
        assert not got[i].any()


def test_backward_takes_the_weight_gradient_on_cpu_tensors():
    rng = np.random.RandomState(4)
    gs = torch.tensor([3, 0, 6], dtype=torch.int32)
    lhs = torch.from_numpy(rng.randn(9, 8).astype(np.float32))
    rhs = torch.from_numpy(rng.randn(3, 8, 5).astype(np.float32))
    lhs.requires_grad_()
    rhs.requires_grad_()
    calls = []
    real = gmm.grouped_matmul_wgrad

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    gmm.grouped_matmul_wgrad = spy
    try:
        gmm.grouped_matmul(lhs, rhs, gs).sum().backward()
    finally:
        gmm.grouped_matmul_wgrad = real
    assert calls == [3]
    want = gmm._segment_outer(lhs.detach(), torch.ones(9, 5), gs, 3)
    torch.testing.assert_close(rhs.grad, want)


def test_weight_gradient_refuses_bad_inputs_by_name():
    lhs, g = torch.ones(6, 4), torch.ones(6, 3)
    gs = torch.tensor([2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"grouped_matmul_wgrad: want lhs"):
        gmm.grouped_matmul_wgrad(lhs, torch.ones(5, 3), gs, 2)
    with pytest.raises(ValueError, match=r"group_sizes \(3,\) must be"):
        gmm.grouped_matmul_wgrad(lhs, g, torch.ones(3, dtype=torch.int32),
                                 2)
    with pytest.raises(TypeError, match="must have lhs's dtype"):
        gmm.grouped_matmul_wgrad(lhs, g.double(), gs, 2)
    with pytest.raises(ValueError, match="g is on meta"):
        gmm.grouped_matmul_wgrad(lhs, g.to("meta"), gs, 2)
    with pytest.raises(ValueError, match="group_sizes is on meta"):
        gmm.grouped_matmul_wgrad(lhs, g, gs.to("meta"), 2)
    with pytest.raises(ValueError, match="unsupported device meta"):
        gmm.grouped_matmul_wgrad(lhs.to("meta"), g.to("meta"),
                                 gs.to("meta"), 2)


# ---------------------------------------------------------------- layer
def test_ragged_layer_adamw_steps_match_jax():
    d, e, f = 16, 4, 32
    paddle.seed(0)
    jl = JaxMoELayer(d_model=d, num_experts=e, d_ff=f, k=2, impl="ragged")
    pl = MoELayer(d, e, f, k=2, impl="ragged", device="cpu")
    pl.load_state_dict({n: torch.from_numpy(np.array(p.numpy()))
                        for n, p in jl.state_dict().items()})
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=jl.parameters())
    popt = topt.AdamW(learning_rate=1e-2, parameters=pl.parameters())
    rng = np.random.RandomState(0)
    for step in range(2):
        x = rng.randn(2, 12, d).astype(np.float32)
        w = rng.randn(2, 12, d).astype(np.float32)
        jout, jaux = jl(paddle.to_tensor(x))
        jloss = (jout * paddle.to_tensor(w)).sum() + jaux
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        out, aux = pl(torch.from_numpy(x))
        loss = (out * torch.from_numpy(w)).sum() + aux
        loss.backward()
        popt.step()
        popt.clear_grad()
        np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                                   **LAYER_TOL)
    jp = dict(jl.named_parameters())
    for name, p in pl.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(),
                                   **LAYER_TOL, err_msg=name)
    jstate, pstate = jopt.state_dict(), popt.state_dict()
    moments = [k for k in pstate if "moment" in k]
    assert moments and set(moments) <= set(jstate)
    for key in moments:
        np.testing.assert_allclose(pstate[key].numpy(),
                                   np.asarray(jstate[key].numpy()),
                                   **LAYER_TOL, err_msg=key)


# ---------------------------------------------------------------- Llama
def test_tiny_llama_moe_train_step_matches_jax():
    cfg = dict(num_experts=4, num_key_value_heads=2)
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(**cfg))
    pm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_reference_state(pm, {k: v.numpy()
                              for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(1).randint(1, 128, (2, 12)).astype(np.int64)
    # the first step's gradients
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jloss.backward()
    _, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    loss.backward()
    jg = dict(jm.named_parameters())
    linear = {f"{n}.weight" for n, m in pm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in pm.named_parameters():
        want = jg[name].grad.numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want.T if name in linear else want,
            **LLAMA_TOL, err_msg=name)
        jg[name].grad = None
        p.grad = None

    def jloss_fn(m, x):
        return m(x, labels=x)[1]

    jstep = paddle.jit.TrainStep(
        jm, jloss_fn, paddle.optimizer.AdamW(learning_rate=1e-3,
                                             parameters=jm.parameters()),
        donate=False)
    pstep = TrainStep(pm, lambda m, x: m(x, labels=x)[1],
                      topt.AdamW(learning_rate=1e-3,
                                 parameters=pm.parameters()))
    for _ in range(3):
        jl = float(jstep(paddle.to_tensor(ids)).numpy())
        pl = pstep(torch.from_numpy(ids)).item()
        np.testing.assert_allclose(pl, jl, **LLAMA_TOL)
    jw = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        want = jw[name].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), want.T if name in linear else want,
            **LLAMA_TOL, err_msg=name)
