"""The port's pretraining path against the JAX package's, on the CPU.

The same numpy inputs (fixed seeds) go through the JAX functions and their
PyTorch counterparts: the losses (``cross_entropy``,
``fused_linear_cross_entropy``) with their gradients, the tiny Llama's
loss and per-parameter gradients on converted weights, and a 10-step
``TrainStep`` loss curve. f32 tolerance atol 1e-5, rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.impl.fused_ops import (
    fused_linear_cross_entropy as jax_fused_ce,
)
from paddle_tpu.ops.impl.nn_ops import cross_entropy as jax_ce
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_reference_state,
)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import cross_entropy, fused_linear_cross_entropy
from paddle_tpu_torch.optimizer import AdamW

TOL = dict(atol=1e-5, rtol=1e-4)
VARIANTS = {
    "mha": {},
    "gqa": {"num_key_value_heads": 2},
    "tied": {"tie_word_embeddings": True},
}


def _np(t):
    return t.detach().numpy()


def _labels(n, vocab, seed, ignore=(1, 5)):
    y = np.random.RandomState(seed).randint(0, vocab, n).astype(np.int64)
    y[list(ignore)] = -100
    return y


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    logits = (3 * np.random.RandomState(0).randn(9, 17)).astype(np.float32)
    y = _labels(9, 17, 1)
    x = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy(x, torch.from_numpy(y), reduction=reduction)
    jloss = jax_ce(jnp.asarray(logits), jnp.asarray(y), reduction=reduction)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TOL)
    # gradient of the summed loss
    loss.sum().backward()
    jgrad = jax.grad(lambda z: jnp.sum(jax_ce(
        z, jnp.asarray(y), reduction=reduction)))(jnp.asarray(logits))
    np.testing.assert_allclose(_np(x.grad), np.asarray(jgrad), **TOL)


def test_cross_entropy_all_ignored_is_zero():
    x = torch.randn(3, 5, requires_grad=True)
    loss = cross_entropy(x, torch.full((3,), -100))
    assert loss.item() == 0.0
    loss.backward()
    assert torch.count_nonzero(x.grad) == 0


@pytest.mark.parametrize("chunk", [4, 5, 64], ids=["divides", "ragged",
                                                  "one_chunk"])
def test_fused_linear_cross_entropy_matches_jax(chunk):
    rng = np.random.RandomState(2)
    x = rng.randn(12, 8).astype(np.float32)
    w = rng.randn(8, 33).astype(np.float32)      # JAX layout [d, vocab]
    y = _labels(12, 33, 3, ignore=(0, 7, 11))
    y[4] = 40                                    # out of range: clamped

    def jax_loss(x_, w_):
        return jax_fused_ce(x_, w_, jnp.asarray(y), chunk_size=chunk)

    jloss, (jdx, jdw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()   # port: [vocab, d]
    loss = fused_linear_cross_entropy(tx, tw, torch.from_numpy(y),
                                      chunk_size=chunk)
    loss.backward()
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw).T, **TOL)
    # and the plain cross entropy over the full logits
    plain = cross_entropy(torch.from_numpy(x @ w), torch.from_numpy(
        np.where(y == 40, 32, y)))
    np.testing.assert_allclose(_np(loss), _np(plain), **TOL)


def _pair(variant, seed=0, **over):
    cfg = dict(VARIANTS[variant], **over)
    paddle.seed(seed)
    jax_model = JaxLlama(JaxLlamaConfig.tiny(**cfg))
    state = {k: v.numpy() for k, v in jax_model.state_dict().items()}
    port = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_reference_state(port, state)
    return jax_model, port


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return request.param, _pair(request.param)


def _ids(seed, b=2, s=12):
    return np.random.RandomState(seed).randint(1, 128, (b, s)).astype(
        np.int64)


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["stored", "recompute"])
@pytest.mark.parametrize("chunk", [0, 16], ids=["logits", "fused16"])
def test_loss_and_grads_match_jax(pair, chunk, recompute):
    variant, (jax_model, port) = pair
    for cfg in (jax_model.config, port.config):
        cfg.fused_loss_chunk, cfg.recompute = chunk, recompute
    ids = _ids(4)
    # padding-free labels with two ignored positions
    labels = ids.copy()
    labels[0, 3] = labels[1, 7] = -100
    for p in jax_model.parameters():
        p.grad = None
    jlogits, jloss = jax_model(paddle.to_tensor(ids),
                               labels=paddle.to_tensor(labels))
    jloss.backward()
    port.zero_grad(set_to_none=True)
    logits, loss = port(torch.from_numpy(ids),
                        labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(_np(loss), jloss.numpy(), **TOL)
    if chunk:
        assert logits is None and jlogits is None
    else:
        np.testing.assert_allclose(_np(logits), jlogits.numpy(), **TOL)
    jgrads = dict(jax_model.named_parameters())
    linear = _linear_names(port)
    for name, p in port.named_parameters():
        want = jgrads[name].grad.numpy()
        np.testing.assert_allclose(
            _np(p.grad), want.T if name in linear else want, **TOL,
            err_msg=name,
        )


def test_forward_contract_and_mask_match_jax():
    jax_model, port = _pair("gqa")
    ids = _ids(5)
    keep = np.ones((2, 1, 1, 12), bool)
    keep[1, ..., 2:5] = False   # keys 2..4 of sequence 1: every row keeps
    #                             key 0, so no row is fully masked
    with torch.no_grad():
        bare = port(torch.from_numpy(ids))
        logits, loss = port(torch.from_numpy(ids),
                            labels=torch.from_numpy(ids))
        masked = port(torch.from_numpy(ids),
                      attn_mask=torch.from_numpy(keep))
    torch.testing.assert_close(bare, logits, rtol=0, atol=0)
    assert loss.dim() == 0
    jmasked = jax_model(paddle.to_tensor(ids),
                        attn_mask=paddle.to_tensor(keep)).numpy()
    assert np.isfinite(jmasked).all()
    np.testing.assert_allclose(_np(masked), jmasked, **TOL)
    # causal rows 0, 1 never saw keys 2..4; later rows did
    np.testing.assert_allclose(_np(masked)[1, :2], _np(bare)[1, :2], **TOL)
    assert np.abs(_np(masked)[1, 2:] - _np(bare)[1, 2:]).min() > 1e-6


def _jax_loss(m, ids):
    return m(ids, labels=ids)[1]


def _port_loss(m, ids):
    return m(ids, labels=ids)[1]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_loss_curve_matches_jax(variant):
    # 10 AdamW steps (decoupled decay, global-norm clip) on one batch.
    # A few gradient elements sit at f32 rounding noise (|g| ~ 1e-8, where
    # the two frameworks' summation orders disagree in sign); with a tiny
    # epsilon Adam moves such an element by ~lr whichever way the rounding
    # tips. epsilon = 1e-3 keeps each step proportional to the gradient
    # there, so the comparison sees the optimizer's math, not the noise;
    # lr = 3e-3 keeps the curve from overshooting (an oscillating curve
    # amplifies f32 differences step over step)
    jax_model, port = _pair(variant, seed=1, fused_loss_chunk=8)
    kw = dict(learning_rate=3e-3, weight_decay=0.1, epsilon=1e-3)
    jopt = paddle.optimizer.AdamW(
        parameters=jax_model.parameters(), **kw,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    topt = AdamW(parameters=port.parameters(), **kw,
                 grad_clip=ClipGradByGlobalNorm(1.0))
    jstep = paddle.jit.TrainStep(jax_model, _jax_loss, jopt, donate=False)
    tstep = TrainStep(port, _port_loss, topt)
    ids = _ids(6, b=4, s=16)
    jl = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(10)]
    tl = [tstep(torch.from_numpy(ids)).item() for _ in range(10)]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    jparams = dict(jax_model.named_parameters())
    linear = _linear_names(port)
    for name, p in port.named_parameters():
        want = jparams[name].numpy()
        np.testing.assert_allclose(_np(p), want.T if name in linear else want,
                                   **TOL, err_msg=name)
        assert p.grad is None


def test_accum_steps_equals_full_batch():
    ids = torch.from_numpy(_ids(7, b=4, s=10))

    def run(accum):
        model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                                 device="cpu", seed=2)
        opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
        step = TrainStep(model, _port_loss, opt, accum_steps=accum)
        losses = [step(ids).item() for _ in range(3)]
        return losses, [p.detach().clone() for p in model.parameters()]

    full_losses, full = run(None)
    acc_losses, acc = run(2)
    # the mean of two half-batch means equals the full-batch mean: every
    # row has the same number of (unignored) labels
    np.testing.assert_allclose(acc_losses, full_losses, rtol=1e-5)
    for a, b in zip(acc, full):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_accum_steps_rejects_bad_inputs():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
    with pytest.raises(ValueError, match="divisible"):
        TrainStep(model, _port_loss, opt, accum_steps=3)(
            torch.zeros(4, 5, dtype=torch.int64))
    with pytest.raises(ValueError, match=">= 1"):
        TrainStep(model, _port_loss, opt, accum_steps=0)
