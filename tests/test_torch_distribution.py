"""paddle_tpu_torch.distribution against the JAX package's, on the CPU.

The same parameters and values (numpy, fixed seeds) go through both.
Every deterministic method (``mean``, ``variance``, ``stddev``,
``log_prob``, ``prob``, ``entropy``, every registered ``kl_divergence``)
within 1e-5 relative (atol 1e-5: log-densities cross zero), and their
gradients with respect to the parameters against JAX's tape within 1e-4
relative (atol 1e-5). A method JAX lacks raises the same exception type
here. Draws cannot share JAX's stream: they are held by distribution (2 x
10^4 draws; continuous laws by the Kolmogorov-Smirnov statistic against
scipy's CDF, below 2.69 / sqrt(n); discrete and multivariate ones by
their means and variances within 6 standard errors), their shapes to
JAX's, one generator seed one output. The transforms: forward, inverse,
both log-determinants and shapes against JAX's within 1e-5.
"""
import math

import numpy as np
import pytest
import scipy.stats
import torch

import paddle_tpu
from paddle_tpu import distribution as jd
from paddle_tpu_torch import distribution as pd
from paddle_tpu_torch.distribution import distributions as pdist

N = 20000


def _r(seed=0):
    return np.random.default_rng(seed)


def _pos(shape, seed=0, lo=0.5, hi=2.5):
    return _r(seed).uniform(lo, hi, shape).astype(np.float32)


def _std(shape, seed=0):
    return _r(seed).standard_normal(shape).astype(np.float32)


def _simplex(shape, seed=0):
    p = _pos(shape, seed, 0.2, 1.0)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _mvn_cov():
    a = _std((3, 3), 7)
    return (a @ a.T + 3 * np.eye(3)).astype(np.float32)


# name -> (class, [parameter arrays], {kwargs}, value array)
CASES = {
    "normal": ("Normal", [_std((4,)), _pos((4,), 1)], {}, _std((3, 4), 2)),
    "uniform": ("Uniform", [_std((4,)) - 2, _pos((4,), 1) + 1], {},
                np.array([[-3.0, -1.0, 0.0, 0.5], [-0.5, 0.2, 0.9, 4.0]],
                         np.float32)),
    "bernoulli": ("Bernoulli", [_pos((4,), 0, 0.1, 0.9)], {},
                  np.array([[0, 1, 1, 0], [1, 1, 0, 0]], np.float32)),
    "categorical_logits": ("Categorical", [_std((2, 5))], {},
                           np.array([[0, 4], [3, 1], [2, 2]], np.int64)),
    "categorical_probs": ("Categorical", [], {"probs": _simplex((2, 5))},
                          np.array([[0, 4], [3, 1]], np.int64)),
    "exponential": ("Exponential", [_pos((4,))], {}, _pos((3, 4), 2, 0.1, 3)),
    "laplace": ("Laplace", [_std((4,)), _pos((4,), 1)], {}, _std((3, 4), 2)),
    "lognormal": ("LogNormal", [_std((4,)) * 0.5, _pos((4,), 1, 0.3, 1)], {},
                  _pos((3, 4), 2, 0.1, 4)),
    "gumbel": ("Gumbel", [_std((4,)), _pos((4,), 1)], {}, _std((3, 4), 2)),
    "beta": ("Beta", [_pos((4,)), _pos((4,), 1)], {},
             _pos((3, 4), 2, 0.05, 0.95)),
    "gamma": ("Gamma", [_pos((4,)), _pos((4,), 1)], {},
              _pos((3, 4), 2, 0.1, 4)),
    "dirichlet": ("Dirichlet", [_pos((2, 3))], {}, _simplex((4, 2, 3), 2)),
    "multinomial": ("Multinomial", [6, _simplex((3,))], {},
                    np.array([[1, 2, 3], [6, 0, 0], [0, 4, 2]], np.float32)),
    "poisson": ("Poisson", [np.array([0.3, 3.0, 15.0, 40.0], np.float32)],
                {}, np.array([[0, 2, 14, 41], [1, 5, 16, 39]], np.float32)),
    "geometric": ("Geometric", [_pos((4,), 0, 0.1, 0.9)], {},
                  np.array([[0, 1, 3, 7], [2, 0, 1, 4]], np.float32)),
    "binomial": ("Binomial", [np.array([5, 10, 20, 7], np.float32),
                              _pos((4,), 0, 0.1, 0.9)], {},
                 np.array([[1, 4, 10, 7], [5, 0, 13, 2]], np.float32)),
    "cauchy": ("Cauchy", [_std((4,)), _pos((4,), 1)], {}, _std((3, 4), 2)),
    "chi2": ("Chi2", [_pos((4,), 0, 1, 6)], {}, _pos((3, 4), 2, 0.1, 6)),
    "student_t": ("StudentT", [_pos((4,), 0, 2, 8), _std((4,), 1),
                               _pos((4,), 2)], {}, _std((3, 4), 3)),
    "continuous_bernoulli": ("ContinuousBernoulli",
                             [np.array([0.2, 0.4995, 0.5, 0.8], np.float32)],
                             {}, _pos((3, 4), 2, 0.05, 0.95)),
    "mvn_cov": ("MultivariateNormal", [_std((3,))],
                {"covariance_matrix": _mvn_cov()}, _std((5, 3), 2)),
    "mvn_tril": ("MultivariateNormal", [_std((3,))],
                 {"scale_tril": np.linalg.cholesky(_mvn_cov())},
                 _std((5, 3), 2)),
}
METHODS = ("mean", "variance", "stddev", "entropy", "log_prob", "prob")


def _build(lib, case, wrap, grad=False):
    cls, args, kw, _ = CASES[case]
    leaves = []

    def leaf(a):
        if not isinstance(a, np.ndarray):
            return a
        t = wrap(a)
        if grad:
            if isinstance(t, torch.Tensor):
                t.requires_grad_()
            else:
                t.stop_gradient = False
        leaves.append(t)
        return t

    return getattr(lib, cls)(*[leaf(a) for a in args],
                             **{k: leaf(v) for k, v in kw.items()}), leaves


def _tensor(a):
    return torch.tensor(a)


def _jtensor(a):
    return paddle_tpu.to_tensor(a)


def _call(dist, method, value, wrap):
    attr = getattr(dist, method)
    if method in ("log_prob", "prob"):
        return attr(wrap(value))
    return attr() if callable(attr) else attr


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_deterministic_methods_match_jax(case):
    value = CASES[case][3]
    mine, _ = _build(pd, case, _tensor)
    theirs, _ = _build(jd, case, _jtensor)
    assert tuple(mine.batch_shape) == tuple(theirs.batch_shape)
    assert tuple(mine.event_shape) == tuple(theirs.event_shape)
    for method in METHODS:
        try:
            want = _np(_call(theirs, method, value, _jtensor))
        except (NotImplementedError, AttributeError) as e:
            with pytest.raises(type(e)):
                _call(mine, method, value, _tensor)
            continue
        got = _np(_call(mine, method, value, _tensor))
        assert got.shape == want.shape, (method, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=method)


def _grads(lib, case, wrap):
    value = CASES[case][3]
    dist, leaves = _build(lib, case, wrap, grad=True)
    if lib is pd:
        w = torch.from_numpy(_pos(np.shape(value)[:-1] if case in (
            "dirichlet", "multinomial") or case.startswith("mvn")
            else np.shape(value), 9))
        loss = (dist.log_prob(wrap(value)) * w).sum()
        try:
            loss = loss + dist.entropy().sum()
        except NotImplementedError:
            pass
        loss.backward()
        return [None if t.grad is None else t.grad.numpy() for t in leaves]
    w = _pos(np.shape(value)[:-1] if case in ("dirichlet", "multinomial")
             or case.startswith("mvn") else np.shape(value), 9)
    loss = paddle_tpu.ops.sum(dist.log_prob(wrap(value)) * _jtensor(w))
    try:
        loss = loss + paddle_tpu.ops.sum(dist.entropy())
    except NotImplementedError:
        pass
    loss.backward()
    return [None if t.grad is None else t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("case", sorted(set(CASES) - {"uniform"}))
def test_parameter_gradients_match_jax_tape(case):
    mine, theirs = _grads(pd, case, _tensor), _grads(jd, case, _jtensor)
    assert len(mine) == len(theirs) > 0
    assert any(b is not None for b in theirs)
    for a, b in zip(mine, theirs):
        # a parameter JAX keeps off its tape (Binomial's total_count) has
        # no gradient here either
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


KL = {
    "normal": ("Normal", [_std((4,)), _pos((4,), 1)],
               [_std((4,), 2), _pos((4,), 3)]),
    "uniform": ("Uniform", [_std((4,)), _std((4,)) + 1],
                [_std((4,)) - 1, _std((4,)) + 3]),
    "bernoulli": ("Bernoulli", [_pos((4,), 0, 0.1, 0.9)],
                  [_pos((4,), 1, 0.1, 0.9)]),
    "categorical": ("Categorical", [_std((2, 5))], [_std((2, 5), 1)]),
    "exponential": ("Exponential", [_pos((4,))], [_pos((4,), 1)]),
}


@pytest.mark.parametrize("case", sorted(KL))
def test_kl_divergence_and_its_gradients_match_jax(case):
    cls, pa, qa = KL[case]
    outs = []
    for lib, wrap in ((pd, _tensor), (jd, _jtensor)):
        leaves = [wrap(a) for a in pa + qa]
        for t in leaves:
            if isinstance(t, torch.Tensor):
                t.requires_grad_()
            else:
                t.stop_gradient = False
        p = getattr(lib, cls)(*leaves[:len(pa)])
        q = getattr(lib, cls)(*leaves[len(pa):])
        kl = lib.kl_divergence(p, q)
        kl2 = p.kl_divergence(q)
        (kl.sum() if lib is pd else paddle_tpu.ops.sum(kl)).backward()
        outs.append((_np(kl), _np(kl2), [_np(t.grad) for t in leaves]))
    (a, a2, ga), (b, b2, gb) = outs
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a2, b2, rtol=1e-5, atol=1e-6)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5)


def test_unregistered_kl_and_missing_methods_raise_as_jax():
    for lib, wrap in ((pd, _tensor), (jd, _jtensor)):
        n = lib.Normal(wrap(np.float32(0.0)), wrap(np.float32(1.0)))
        e = lib.Exponential(wrap(np.float32(1.0)))
        with pytest.raises(NotImplementedError, match="no KL registered"):
            lib.kl_divergence(n, e)
        g = lib.Gamma(wrap(np.float32(2.0)), wrap(np.float32(1.0)))
        with pytest.raises(NotImplementedError):
            g.rsample([2])
        with pytest.raises(ValueError, match="exactly one"):
            lib.MultivariateNormal(wrap(np.zeros(2, np.float32)))
        with pytest.raises(ValueError, match="logits or probs"):
            lib.Categorical()


def test_registered_kl_extends_to_subclasses_and_new_pairs():
    class Wide(pd.Normal):
        pass

    p = Wide(torch.tensor(0.0), torch.tensor(2.0))
    q = pd.Normal(torch.tensor(1.0), torch.tensor(1.0))
    want = pd.kl_divergence(pd.Normal(torch.tensor(0.0), torch.tensor(2.0)),
                            q)
    assert torch.equal(pd.kl_divergence(p, q), want)

    @pd.register_kl(Wide, pd.Exponential)
    def _kl(a, b):
        return torch.tensor(7.0)

    try:
        assert float(pd.kl_divergence(p, pd.Exponential(torch.tensor(
            1.0)))) == 7.0
    finally:
        del pdist._KL_REGISTRY[(Wide, pd.Exponential)]


def test_independent_and_transformed_match_jax():
    loc, scale = _std((3, 4)), _pos((3, 4), 1)
    v = _pos((3, 4), 2, 0.2, 3)
    outs = []
    for lib, wrap in ((pd, _tensor), (jd, _jtensor)):
        base = lib.Normal(wrap(loc), wrap(scale))
        ind = lib.Independent(base, 1)
        tr = lib.transform
        td = lib.TransformedDistribution(
            lib.Normal(wrap(loc), wrap(scale)),
            [tr.ExpTransform(), tr.AffineTransform(wrap(np.float32(0.5)),
                                                   wrap(np.float32(2.0)))])
        outs.append([_np(ind.log_prob(wrap(v))), _np(ind.entropy()),
                     _np(td.log_prob(wrap(v + 0.6))),
                     tuple(ind.batch_shape)])
        assert tuple(td.sample([5]).shape) == (5, 3, 4)
    for a, b in zip(*outs):
        if isinstance(a, tuple):
            assert a == b
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---- draws ----------------------------------------------------------------
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# name -> (class, args, scipy law) for the KS test
CONTINUOUS = {
    "normal": ("Normal", (0.5, 2.0), scipy.stats.norm(0.5, 2.0)),
    "uniform": ("Uniform", (-1.0, 3.0), scipy.stats.uniform(-1.0, 4.0)),
    "exponential": ("Exponential", (2.0,), scipy.stats.expon(scale=0.5)),
    "laplace": ("Laplace", (0.5, 2.0), scipy.stats.laplace(0.5, 2.0)),
    "lognormal": ("LogNormal", (0.2, 0.7),
                  scipy.stats.lognorm(0.7, scale=math.exp(0.2))),
    "gumbel": ("Gumbel", (0.5, 2.0), scipy.stats.gumbel_r(0.5, 2.0)),
    "gamma": ("Gamma", (2.5, 1.5), scipy.stats.gamma(2.5, scale=1 / 1.5)),
    "beta": ("Beta", (2.0, 0.7), scipy.stats.beta(2.0, 0.7)),
    "cauchy": ("Cauchy", (0.5, 2.0), scipy.stats.cauchy(0.5, 2.0)),
    "chi2": ("Chi2", (3.0,), scipy.stats.chi2(3.0)),
    "student_t": ("StudentT", (4.0, 0.5, 2.0), scipy.stats.t(4.0, 0.5, 2.0)),
}


@pytest.mark.parametrize("case", sorted(CONTINUOUS))
def test_continuous_draws_by_distribution(case):
    cls, args, law = CONTINUOUS[case]
    d = getattr(pd, cls)(*args, device="cpu")
    s = d.sample([N], generator=_gen())
    assert s.shape == (N,) and s.dtype == torch.float32
    ks = scipy.stats.kstest(s.double().numpy(), law.cdf).statistic
    assert ks < 2.69 / math.sqrt(N), ks
    assert torch.equal(s, d.sample([N], generator=_gen()))
    jax_shape = getattr(jd, cls)(*[paddle_tpu.to_tensor(np.float32(a))
                                   for a in args]).sample([3, 2]).shape
    assert list(d.sample([3, 2]).shape) == list(jax_shape)


def test_continuous_bernoulli_draws_by_distribution():
    for p in (0.2, 0.5):
        d = pd.ContinuousBernoulli(p, device="cpu")
        s = d.sample([N], generator=_gen()).double().numpy()
        grid = np.linspace(0.0, 1.0, 401)
        dens = np.exp(d.log_prob(torch.from_numpy(
            grid.astype(np.float32))).double().numpy())
        cdf = np.concatenate([[0.0], np.cumsum(
            (dens[1:] + dens[:-1]) / 2 * np.diff(grid))])
        ks = scipy.stats.kstest(s, lambda v: np.interp(v, grid, cdf))
        assert ks.statistic < 2.69 / math.sqrt(N) + 1e-3, (p, ks.statistic)


def _moments(sample, mean, var, k=6.0):
    a = sample.double().numpy()
    n = a.shape[0]
    np.testing.assert_array_less(np.abs(a.mean(0) - mean),
                                 k * np.sqrt(var / n) + 1e-12)
    m4 = np.mean((a - a.mean(0)) ** 4, 0)
    se = np.sqrt(np.maximum(m4 - a.var(0) ** 2, 1e-30) / n)
    np.testing.assert_array_less(np.abs(a.var(0) - var), k * se + 1e-12)


def test_discrete_and_multivariate_draws_by_distribution():
    g = _gen
    p = np.array([0.1, 0.5, 0.85], np.float32)
    _moments(pd.Bernoulli(p, device="cpu").sample([N], g()), p, p * (1 - p))
    lam = np.array([0.3, 4.0, 30.0], np.float32)
    s = pd.Poisson(lam, device="cpu").sample([N], g())
    assert s.dtype == torch.float32
    _moments(s, lam, lam)
    _moments(pd.Geometric(p, device="cpu").sample([N], g()), (1 - p) / p,
             (1 - p) / p ** 2)
    n = np.array([5.0, 12.0, 40.0], np.float32)
    _moments(pd.Binomial(n, p, device="cpu").sample([N], g()), n * p,
             n * p * (1 - p))
    probs = _simplex((6,))
    c = pd.Categorical(probs=probs, device="cpu").sample([N], g())
    k = np.arange(6)
    mean = (probs * k).sum()
    _moments(c[:, None], mean, (probs * k ** 2).sum() - mean ** 2)
    m = pd.Multinomial(7, probs, device="cpu").sample([N], g())
    assert m.shape == (N, 6) and bool((m.sum(-1) == 7).all())
    _moments(m, 7 * probs, 7 * probs * (1 - probs))
    alpha = np.array([0.5, 2.0, 3.0], np.float32)
    a0 = alpha.sum()
    _moments(pd.Dirichlet(alpha, device="cpu").sample([N], g()), alpha / a0,
             alpha * (a0 - alpha) / (a0 ** 2 * (a0 + 1)))
    cov = _mvn_cov()
    loc = _std((3,))
    s = pd.MultivariateNormal(loc, covariance_matrix=cov,
                              device="cpu").rsample([N], g())
    _moments(s, loc, np.diag(cov))
    emp = np.cov(s.double().numpy().T)
    se = np.sqrt((cov ** 2 + np.outer(np.diag(cov), np.diag(cov))) / N)
    np.testing.assert_array_less(np.abs(emp - cov), 6 * se)


def test_draw_shapes_match_jax():
    # JAX's draw is [*shape, *batch_shape, *event_shape], the
    # MultivariateNormal's [*shape, *loc.shape] (its samplers' compiles
    # are slow on the CPU: read from its shapes)
    for case in ("bernoulli", "categorical_logits", "dirichlet",
                 "multinomial", "poisson", "geometric", "binomial",
                 "continuous_bernoulli", "mvn_cov", "gamma", "beta"):
        mine, _ = _build(pd, case, _tensor)
        theirs, _ = _build(jd, case, _jtensor)
        event = (tuple(theirs.loc.shape[-1:]) if case == "mvn_cov"
                 else tuple(theirs.event_shape))
        assert tuple(mine.sample([3, 2]).shape) == (3, 2) + tuple(
            theirs.batch_shape) + event, case


def test_rsample_carries_gradients_sample_does_not_where_jax_does_not():
    loc = torch.tensor([0.5, -1.0], requires_grad=True)
    scale = torch.tensor([2.0, 0.5], requires_grad=True)
    eps = torch.from_numpy(_std((7, 2), 3))
    swap = pdist._randn
    pdist._randn = lambda shape, like, generator: eps
    try:
        out = pd.Normal(loc, scale).rsample([7])
    finally:
        pdist._randn = swap
    torch.testing.assert_close(out, loc + scale * eps)
    out.sum().backward()
    torch.testing.assert_close(loc.grad, torch.full((2,), 7.0))
    torch.testing.assert_close(scale.grad, eps.sum(0))
    rate = torch.tensor([2.0], requires_grad=True)
    conc = torch.tensor([3.0], requires_grad=True)
    g = pd.Gamma(conc, rate).sample([4])
    assert g.requires_grad
    g.sum().backward()
    assert conc.grad is None and rate.grad is not None
    for d in (pd.Beta(conc, rate), pd.Poisson(rate), pd.Chi2(conc),
              pd.ContinuousBernoulli(torch.tensor([0.3],
                                                  requires_grad=True))):
        assert not d.sample([3]).requires_grad


def test_parameters_keep_their_device_and_numbers_take_the_one_named():
    d = pd.Normal(0.0, np.array([1.0, 2.0]), device="cpu")
    assert d.loc.device.type == "cpu" and d.scale.dtype == torch.float32
    with pytest.raises(ValueError, match="different devices"):
        pd.Normal(torch.zeros(2), torch.ones(2, device="meta"))
    with pytest.raises(ValueError):
        pd.Normal(torch.zeros(2), 1.0, device="meta")
    d64 = pd.Normal(torch.zeros(2, dtype=torch.float64), 1.0)
    assert d64.log_prob(torch.zeros(2, dtype=torch.float64)).dtype == \
        torch.float64


# ---- transforms ------------------------------------------------------------
def _transforms(lib, wrap):
    tr = lib.transform
    return {
        "abs": tr.AbsTransform(),
        "affine": tr.AffineTransform(wrap(_std((4,))), wrap(_pos((4,), 1))),
        "exp": tr.ExpTransform(),
        "power": tr.PowerTransform(wrap(np.float32(2.5))),
        "sigmoid": tr.SigmoidTransform(),
        "tanh": tr.TanhTransform(),
        "softmax": tr.SoftmaxTransform(),
        "stick_breaking": tr.StickBreakingTransform(),
        "reshape": tr.ReshapeTransform((2, 2), (4,)),
        "independent": tr.IndependentTransform(tr.ExpTransform(), 1),
        "chain": tr.ChainTransform([
            tr.AffineTransform(wrap(np.float32(0.5)), wrap(np.float32(2.0))),
            tr.ExpTransform(), tr.PowerTransform(wrap(np.float32(0.5)))]),
        "chain_event": tr.ChainTransform([tr.ExpTransform(),
                                          tr.StickBreakingTransform()]),
        "stack": tr.StackTransform([tr.ExpTransform(), tr.TanhTransform(),
                                    tr.SigmoidTransform()], axis=1),
    }


# name -> the input x (in the domain) and y (in the codomain)
T_INPUTS = {
    "abs": (_std((3, 4)), _pos((3, 4))),
    "power": (_pos((3, 4)), _pos((3, 4), 1)),
    "tanh": (_std((3, 4)), _std((3, 4)) * 0.3),
    "sigmoid": (_std((3, 4)), _pos((3, 4), 0, 0.1, 0.9)),
    "softmax": (_std((3, 4)), _simplex((3, 4))),
    "stick_breaking": (_std((3, 4)), _simplex((3, 5))),
    "reshape": (_std((3, 2, 2)), _std((3, 4))),
    "chain": (_std((3, 4)) * 0.3, _pos((3, 4), 1, 1.0, 2.0)),
    "chain_event": (_std((3, 4)), _simplex((3, 5))),
    "stack": (_std((2, 3)), _pos((2, 3), 1, 0.1, 0.9)),
}


@pytest.mark.parametrize("name", sorted(_transforms(pd, _tensor)))
def test_transforms_match_jax(name):
    x, y = T_INPUTS.get(name, (_std((3, 4)), _pos((3, 4), 1)))
    mine = _transforms(pd, _tensor)[name]
    theirs = _transforms(jd, _jtensor)[name]
    assert mine.bijective == theirs.bijective
    for method, arg in (("forward", x), ("inverse", y),
                        ("forward_log_det_jacobian", x),
                        ("inverse_log_det_jacobian", y)):
        try:
            want = getattr(theirs, method)(_jtensor(arg)).numpy()
        except (NotImplementedError, AttributeError, RecursionError) as e:
            with pytest.raises(type(e)):
                getattr(mine, method)(_tensor(arg))
            continue
        got = getattr(mine, method)(_tensor(arg))
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5,
                                   err_msg=method)
    assert mine.forward_shape(x.shape) == theirs.forward_shape(x.shape)
    assert mine.inverse_shape(y.shape) == theirs.inverse_shape(y.shape)
    np.testing.assert_allclose(_np(mine(_tensor(x))),
                               theirs(_jtensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_transform_gradients_and_errors_match_jax():
    x = _std((4,))
    scale = torch.tensor(2.0, requires_grad=True)
    t = pd.transform.AffineTransform(torch.tensor(0.5), scale)
    (t.forward(torch.from_numpy(x)).sum()
     + t.forward_log_det_jacobian(torch.from_numpy(x)).sum()).backward()
    js = paddle_tpu.to_tensor(np.float32(2.0))
    js.stop_gradient = False
    jt = jd.transform.AffineTransform(paddle_tpu.to_tensor(np.float32(0.5)),
                                      js)
    jx = paddle_tpu.to_tensor(x)
    paddle_tpu.ops.sum(jt.forward(jx) + jt.forward_log_det_jacobian(
        jx)).backward()
    np.testing.assert_allclose(float(scale.grad), float(js.grad.numpy()),
                               rtol=1e-6)
    for lib in (pd, jd):
        with pytest.raises(ValueError, match="different sizes"):
            lib.transform.ReshapeTransform((2, 3), (5,))
