"""paddle_tpu_torch ops against the JAX package's functions of the same name.

The same numpy inputs (fixed seeds) go through the JAX function and its
PyTorch counterpart on the CPU; f32 tolerance atol 1e-5, rtol 1e-4
(``cross_entropy``'s forms: 1e-6). Attention dropout cannot share JAX's
random stream: the same keep-mask is injected on both sides, and the
port's own draw is held to identities (p = 0 is no dropout, the keep
rate within binomial bounds, one generator seed one output).
``gumbel_softmax`` draws its noise from another stream than JAX's too: the
two are held to each other by distribution (argmax frequencies within 4
binomial sigma of softmax(x), mean outputs within 4 sigma of each other).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.generation import warp_logits as jax_warp_logits
from paddle_tpu.ops.impl.activation import (
    gumbel_softmax as jax_gumbel_softmax,
)
from paddle_tpu.ops.impl.activation import swiglu as jax_swiglu
from paddle_tpu.ops.impl.fused_ops import rope_qk as jax_rope_qk
from paddle_tpu.ops.impl.nn_ops import cross_entropy as jax_ce
from paddle_tpu.ops.impl.nn_ops import rms_norm as jax_rms_norm
from paddle_tpu.ops.impl.nn_ops import (
    scaled_dot_product_attention as jax_sdpa,
)
from paddle_tpu.ops.impl.nn_ops import (
    softmax_with_cross_entropy as jax_swce,
)
from paddle_tpu_torch.generation import warp_logits
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.ops.activation import gumbel_softmax
from paddle_tpu_torch.ops import (
    cross_entropy,
    nn_ops,
    rms_norm,
    rope_qk,
    scaled_dot_product_attention,
    softmax_with_cross_entropy,
    swiglu,
)

TOL = dict(atol=1e-5, rtol=1e-4)


def _close(port, ref, **tol):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), **(tol or TOL)
    )


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 16)])
def test_rms_norm(shape, eps):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w), epsilon=eps),
           jax_rms_norm(jnp.asarray(x), jnp.asarray(w), epsilon=eps))
    _close(rms_norm(torch.from_numpy(x), epsilon=eps),
           jax_rms_norm(jnp.asarray(x), epsilon=eps))


@pytest.mark.parametrize("begin_norm_axis", [-1, 1, 2])
def test_rms_norm_bias_and_begin_norm_axis(begin_norm_axis):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 8).astype(np.float32)
    shape = x.shape[begin_norm_axis % 3:]
    w = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    kw = dict(epsilon=1e-5, begin_norm_axis=begin_norm_axis)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), **kw),
           jax_rms_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        **kw))
    _close(rms_norm(torch.from_numpy(x), bias=torch.from_numpy(b), **kw),
           jax_rms_norm(jnp.asarray(x), bias=jnp.asarray(b), **kw))


@pytest.mark.parametrize("offset", [None, 0, 7])
def test_rope_qk(offset):
    rng = np.random.RandomState(1)
    q = rng.randn(2, 6, 4, 16).astype(np.float32)
    k = rng.randn(2, 6, 2, 16).astype(np.float32)
    if offset is None:
        pos_np = None
    else:
        # per-row positions, as serving decode passes them
        pos_np = (offset + np.arange(6)[None, :]
                  + np.array([[0], [3]])).astype(np.int32)
    qp, kp = rope_qk(
        torch.from_numpy(q), torch.from_numpy(k),
        None if pos_np is None else torch.from_numpy(pos_np),
        base=500000.0 if offset == 7 else 10000.0,
    )
    qj, kj = jax_rope_qk(
        jnp.asarray(q), jnp.asarray(k),
        None if pos_np is None else jnp.asarray(pos_np),
        base=500000.0 if offset == 7 else 10000.0,
    )
    _close(qp, qj)
    _close(kp, kj)


def test_rope_qk_1d_positions():
    rng = np.random.RandomState(2)
    q = rng.randn(1, 3, 2, 8).astype(np.float32)
    pos = np.array([5, 6, 7], np.int32)
    qp, kp = rope_qk(torch.from_numpy(q), torch.from_numpy(q),
                     torch.from_numpy(pos))
    qj, kj = jax_rope_qk(jnp.asarray(q), jnp.asarray(q), jnp.asarray(pos))
    _close(qp, qj)
    _close(kp, kj)


@pytest.mark.parametrize("shape", [(4, 32), (2, 3, 128)])
def test_swiglu(shape):
    rng = np.random.RandomState(3)
    x = (3 * rng.randn(*shape)).astype(np.float32)
    y = rng.randn(*shape).astype(np.float32)
    _close(swiglu(torch.from_numpy(x), torch.from_numpy(y)),
           jax_swiglu(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize(
    "sq,sk,causal",
    [(8, 8, True), (3, 10, True), (8, 8, False), (5, 12, False)],
    ids=["causal_square", "causal_bottom_right", "full", "full_rect"],
)
def test_sdpa_math(sq, sk, causal):
    rng = np.random.RandomState(4)
    q = rng.randn(2, sq, 4, 16).astype(np.float32)
    k = rng.randn(2, sk, 4, 16).astype(np.float32)
    v = rng.randn(2, sk, 4, 16).astype(np.float32)
    reset_launch_counts()
    port = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=causal,
    )
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   is_causal=causal)
    _close(port, ref)
    # CPU tensors never reach the flash kernel
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_sdpa_mask(mask_kind):
    rng = np.random.RandomState(5)
    q = rng.randn(1, 4, 2, 8).astype(np.float32)
    k = rng.randn(1, 9, 2, 8).astype(np.float32)
    v = rng.randn(1, 9, 2, 8).astype(np.float32)
    # the generate() cached-branch keep mask: key j visible to query i
    # when j <= position + i
    keep = (np.arange(9)[None, :] <= (3 + np.arange(4))[:, None])[None, None]
    mask = keep if mask_kind == "bool" else np.where(
        keep, 0.0, -1e30
    ).astype(np.float32)
    port = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask),
    )
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(mask))
    _close(port, ref)


def test_sdpa_gqa_math_repeats_kv():
    rng = np.random.RandomState(6)
    q = rng.randn(1, 5, 4, 8).astype(np.float32)
    k = rng.randn(1, 5, 2, 8).astype(np.float32)
    v = rng.randn(1, 5, 2, 8).astype(np.float32)
    port = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True,
    )
    ref = jax_sdpa(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                   jnp.repeat(jnp.asarray(v), 2, axis=2), is_causal=True)
    _close(port, ref)


@pytest.mark.parametrize(
    "temperature,top_k,top_p",
    [(1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.6),
     (1.3, 12, 0.8)],
    ids=["noop", "temperature", "top_k", "top_p", "all"],
)
def test_warp_logits_scalar(temperature, top_k, top_p):
    rng = np.random.RandomState(7)
    logits = rng.randn(3, 40).astype(np.float32)
    _close(warp_logits(torch.from_numpy(logits), temperature, top_k, top_p),
           jax_warp_logits(jnp.asarray(logits), temperature, top_k, top_p))


def test_warp_logits_top_k_ties():
    # tokens tied with the k-th largest logit are all kept
    logits = np.array([[3.0, 1.0, 2.0, 2.0, 2.0, 0.5]], np.float32)
    port = warp_logits(torch.from_numpy(logits), 1.0, 2, 1.0)
    _close(port, jax_warp_logits(jnp.asarray(logits), 1.0, 2, 1.0))
    assert int((port > -1e29).sum()) == 4


def test_warp_logits_per_row():
    rng = np.random.RandomState(8)
    logits = rng.randn(4, 32).astype(np.float32)
    t = np.array([0.7, 1.0, 1.3, 0.9], np.float32)
    k = np.array([5, 0, 12, 3], np.int32)
    p = np.array([0.8, 1.0, 0.5, 0.95], np.float32)
    port = warp_logits(torch.from_numpy(logits), torch.from_numpy(t),
                       torch.from_numpy(k), torch.from_numpy(p))
    _close(port, jax_warp_logits(jnp.asarray(logits), jnp.asarray(t),
                                 jnp.asarray(k), jnp.asarray(p)))


# ---------------------------------------------------------- cross entropy
CE_TOL = dict(atol=1e-6, rtol=1e-6)


def _ce_inputs(n=6, c=11, seed=10):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(n, c)).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int64)
    labels[[1, 4]] = -100
    soft = rng.rand(n, c).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = (0.5 + rng.rand(c)).astype(np.float32)
    return logits, labels, soft, weight


def _ce_pair(logits, label, weight=None, **kw):
    port = cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                         None if weight is None else torch.from_numpy(weight),
                         **kw)
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(label),
                 None if weight is None else jnp.asarray(weight), **kw)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **CE_TOL)
    return port


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_n1_labels_match_n_labels(reduction):
    # [N, 1] hard labels (paddle's usual layout) are the [N] labels: the
    # label axis of the logits' rank is squeezed, as in the JAX op
    logits, labels, _, _ = _ce_inputs()
    flat = _ce_pair(logits, labels, reduction=reduction)
    col = _ce_pair(logits, labels[:, None], reduction=reduction)
    np.testing.assert_array_equal(col.numpy(), flat.numpy())


CE_FORMS = {
    "weight_ignore": dict(weighted=True),
    "weight_ignore_sum": dict(weighted=True, reduction="sum"),
    "weight_ignore_none": dict(weighted=True, reduction="none"),
    "smooth_hard": dict(label_smoothing=0.1),
    "smooth_hard_weight": dict(weighted=True, label_smoothing=0.2),
    "ignore_other_index": dict(ignore_index=3),
    "probabilities": dict(use_softmax=False),
}


@pytest.mark.parametrize("form", sorted(CE_FORMS))
def test_cross_entropy_hard_label_forms(form):
    kw = dict(CE_FORMS[form])
    logits, labels, _, weight = _ce_inputs()
    if kw.pop("weighted", False) is False:
        weight = None
    if "ignore_index" in kw:
        labels = np.where(labels == -100, kw["ignore_index"], labels)
    if kw.get("use_softmax") is False:
        logits = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        logits[0, 0] = 0.0                # clipped at 1e-30 before the log
    _ce_pair(logits, labels, weight, **kw)


@pytest.mark.parametrize("smoothing", [0.0, 0.15])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("explicit", [True, False],
                         ids=["soft_label", "by_shape"])
def test_cross_entropy_soft_labels(explicit, reduction, smoothing):
    logits, _, soft, _ = _ce_inputs()
    kw = dict(reduction=reduction, label_smoothing=smoothing)
    if explicit:
        kw["soft_label"] = True
    _ce_pair(logits, soft, **kw)


def test_cross_entropy_soft_labels_on_axis_1():
    rng = np.random.RandomState(11)
    logits = rng.randn(2, 5, 3).astype(np.float32)
    soft = rng.rand(2, 5, 3).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    _ce_pair(logits, soft, axis=1, reduction="none", label_smoothing=0.1)


def test_cross_entropy_hard_labels_on_axis_1_gather_there():
    # the class axis in the middle: the label's log-probability along it,
    # the JAX op's answer with the class axis moved last (the JAX op
    # itself gathers along the wrong axis there)
    rng = np.random.RandomState(12)
    logits = rng.randn(3, 5, 4).astype(np.float32)
    labels = rng.randint(0, 5, (3, 4)).astype(np.int64)
    port = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         axis=1, reduction="none")
    ref = jax_ce(jnp.asarray(np.moveaxis(logits, 1, -1)),
                 jnp.asarray(labels), reduction="none")
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **CE_TOL)


def test_cross_entropy_gradient_with_weight_and_smoothing():
    logits, labels, _, weight = _ce_inputs(seed=13)
    x = torch.from_numpy(logits).requires_grad_()
    cross_entropy(x, torch.from_numpy(labels), torch.from_numpy(weight),
                  label_smoothing=0.1).backward()
    want = jax.grad(lambda z: jax_ce(z, jnp.asarray(labels),
                                     jnp.asarray(weight),
                                     label_smoothing=0.1))(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **CE_TOL)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy(soft):
    logits, labels, soft_labels, _ = _ce_inputs(seed=14)
    label = soft_labels if soft else labels[:, None]
    loss, sm = softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label), soft_label=soft,
        return_softmax=True)
    jloss, jsm = jax_swce(jnp.asarray(logits), jnp.asarray(label),
                          soft_label=soft, return_softmax=True)
    assert loss.shape == (6, 1)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **CE_TOL)
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm), **CE_TOL)


# ------------------------------------------------------ attention dropout
def _qkv(seed, b=2, s=6, h=4, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_dropout_with_one_injected_mask_matches_jax(monkeypatch,
                                                         causal):
    q, k, v = _qkv(20)
    p = 0.3
    keep = np.random.RandomState(21).rand(2, 4, 6, 6) >= p
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, prob, shape: jnp.asarray(keep))
    monkeypatch.setattr(nn_ops, "_keep_mask",
                        lambda p_, shape, device, gen: torch.from_numpy(keep))
    port = scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), dropout_p=p,
        is_causal=causal)
    ref = jax_sdpa(*(jnp.asarray(t) for t in (q, k, v)), dropout_p=p,
                   is_causal=causal, key_rng=jax.random.PRNGKey(0))
    _close(port, ref)


def test_sdpa_dropout_identities():
    q, k, v = (torch.from_numpy(t) for t in _qkv(22, b=4, s=32, d=16))
    plain = scaled_dot_product_attention(q, k, v)
    # p = 0 is no dropout, whatever the generator
    torch.testing.assert_close(
        scaled_dot_product_attention(
            q, k, v, dropout_p=0.0,
            generator=torch.Generator().manual_seed(1)),
        plain, rtol=0, atol=0)
    # one generator seed, one output; another seed, another output
    outs = [scaled_dot_product_attention(
        q, k, v, dropout_p=0.1, generator=torch.Generator().manual_seed(s))
        for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    # the keep rate of the probabilities within 5 sigma of binomial(1 - p)
    p = 0.1
    keep = nn_ops._keep_mask(p, (4, 4, 32, 32), torch.device("cpu"),
                             torch.Generator().manual_seed(7))
    n = keep.numel()
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(int(keep.sum()) - n * (1 - p)) <= 5 * sigma


def test_sdpa_dropout_is_not_flash_eligible():
    # JAX's gate refuses dropout; a dropout call on the card takes the
    # math form (no kernel keeps a mask)
    t = types.SimpleNamespace(shape=(2, 16, 4, 64), dtype=torch.bfloat16,
                              device=types.SimpleNamespace(type="cuda"),
                              requires_grad=False)
    assert nn_ops.flash_eligible(t, t, t, None, False)
    assert not nn_ops.flash_eligible(t, t, t, None, False, dropout_p=0.1)


# --------------------------------------------------------- gumbel_softmax
@pytest.mark.parametrize("shape", [(4, 6, 5), (1000, 50)],
                         ids=["4x6x5", "1000x50"])
def test_gumbel_softmax_rows_sum_to_one(shape):
    x = torch.from_numpy(np.random.RandomState(30).randn(*shape)
                         .astype(np.float32))
    y = gumbel_softmax(x, generator=torch.Generator().manual_seed(0))
    assert y.shape == x.shape and y.dtype == x.dtype
    assert not y.isnan().any() and bool((y >= 0).all())
    torch.testing.assert_close(y.sum(-1), torch.ones(shape[:-1]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_gumbel_softmax_argmax_frequencies_match_jax(tau):
    # argmax((x + g) / tau) = argmax(x + g): with g Gumbel, class i wins
    # with probability softmax(x)_i at every temperature. Port and JAX op
    # each within 4 binomial sigma of it over n draws (the rows of one
    # call), and their mean outputs, which do depend on tau, within 4
    # sigma of each other
    n = 20000
    x = np.random.RandomState(31).randn(5).astype(np.float32)
    xs = np.tile(x, (n, 1))
    port = gumbel_softmax(torch.from_numpy(xs), temperature=tau,
                          generator=torch.Generator().manual_seed(1)).numpy()
    ref = np.asarray(jax_gumbel_softmax(jnp.asarray(xs),
                                        key=jax.random.PRNGKey(1),
                                        temperature=tau))
    p = np.exp(x - x.max())
    p /= p.sum()
    sigma = np.sqrt(n * p * (1 - p))
    for y in (port, ref):
        assert np.isfinite(y).all()
        counts = np.bincount(y.argmax(-1), minlength=5)
        assert (np.abs(counts - n * p) <= 4 * sigma).all(), (counts, n * p)
    se = np.sqrt((port.var(0) + ref.var(0)) / n)
    assert (np.abs(port.mean(0) - ref.mean(0)) <= 4 * se).all()


def test_gumbel_softmax_hard_is_one_hot_with_soft_gradient():
    # one generator seed, one noise: the hard output is the one-hot of the
    # soft output's argmax, and its gradient is the soft output's. The
    # soft output is softmax((x + g) / tau) with g = -log(-log(u)) of the
    # generator's uniform draw (computed here in float64)
    tau = 0.7
    x0 = np.random.RandomState(32).randn(8, 6).astype(np.float32)
    w = torch.from_numpy(np.random.RandomState(33).randn(8, 6)
                         .astype(np.float32))

    def run(hard):
        x = torch.from_numpy(x0.copy()).requires_grad_()
        y = gumbel_softmax(x, temperature=tau, hard=hard,
                           generator=torch.Generator().manual_seed(4))
        (y * w).sum().backward()
        return y.detach(), x.grad

    soft, g_soft = run(False)
    hard, g_hard = run(True)
    u = torch.rand((8, 6), generator=torch.Generator().manual_seed(4))
    noise = -torch.log(-torch.log(u.double()))
    want = torch.softmax((torch.from_numpy(x0).double() + noise) / tau, -1)
    torch.testing.assert_close(soft.double(), want, rtol=1e-5, atol=1e-6)
    one_hot = torch.zeros_like(soft).scatter_(-1, soft.argmax(-1, True), 1.0)
    torch.testing.assert_close(hard, one_hot, rtol=0, atol=1e-6)
    assert bool((hard.sum(-1) == 1).all())
    torch.testing.assert_close(g_hard, g_soft, rtol=0, atol=0)
    assert g_soft.abs().sum() > 0
