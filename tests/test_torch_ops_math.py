"""paddle_tpu_torch's math, complex and random ops against the JAX
package's functions of the same name (``paddle_tpu/ops/impl/math.py``,
``random.py``, the complex constructors), on the CPU.

The same numpy inputs (fixed seeds) go through both; f32 values within
rtol 1e-5 (atol 1e-6 where a function crosses zero in the range: lgamma,
digamma, the trigonometric ones). Two functions need more and say why:
``polygamma`` (rtol 1e-5 at n 1, 2, 3 is 2e-7-1e-6 here, held to 5e-6:
JAX sums a series, torch a recurrence) and ``gammaincc`` (atol 5e-6: a
continued fraction against a series, the larger gap of the two in [0.1,
6]). A gradient reaching a complex leaf is the conjugate of JAX's (the
port keeps torch's convention, ROADMAP Queue C); real compositions match
JAX's tape. The random ops cannot share JAX's stream: their draws are
held by distribution (2 x 10^4 draws, means and variances within 6
standard errors of the law's and of JAX's draws), one generator seed one
output, and the creation ops placed on the device asked for.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.ops as jax_ops
from paddle_tpu.ops.impl import creation as jc
from paddle_tpu.ops.impl import manipulation as jmanip
from paddle_tpu.ops.impl import math as jm
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import manipulation as pmanip
from paddle_tpu_torch.ops import math as pm
from paddle_tpu_torch.ops import random as pr

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _u(lo, hi, shape=(4, 16), seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# name -> the input range of the JAX op's domain
UNARY = {
    "abs": (-3, 3), "acos": (-0.95, 0.95), "acosh": (1.05, 5),
    "asin": (-0.95, 0.95), "asinh": (-3, 3), "atan": (-3, 3),
    "atanh": (-0.95, 0.95), "ceil": (-3, 3), "cos": (-3, 3),
    "cosh": (-3, 3), "digamma": (0.1, 6), "erf": (-3, 3),
    "erfinv": (-0.99, 0.99), "exp": (-3, 3), "expm1": (-3, 3),
    "floor": (-3, 3), "lgamma": (0.1, 6), "log": (0.1, 5),
    "log10": (0.1, 5), "log1p": (-0.9, 5), "log2": (0.1, 5),
    "logit": (0.05, 0.95), "neg": (-3, 3), "reciprocal": (0.2, 3),
    "round": (-3, 3), "rsqrt": (0.1, 5), "sign": (-3, 3),
    "sin": (-3, 3), "sinh": (-3, 3), "sqrt": (0.1, 5), "square": (-3, 3),
    "tan": (-1.2, 1.2), "tanh": (-3, 3), "sigmoid": (-3, 3),
    "trunc": (-3, 3), "frac": (-3, 3), "angle": (-3, 3), "conj": (-3, 3),
    "real": (-3, 3), "imag": (-3, 3), "i0": (-4, 4), "i0e": (-4, 4),
    "i1": (-4, 4), "i1e": (-4, 4), "sinc": (-3, 3), "deg2rad": (-90, 90),
    "rad2deg": (-3, 3), "gammaln": (0.1, 6), "signbit": (-3, 3),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_matches_jax(name):
    x = _u(*UNARY[name])
    got = getattr(ops, name)(torch.from_numpy(x))
    want = getattr(jm, name)(jnp.asarray(x))
    assert got.shape == want.shape
    _close(got, want)


# name -> the two inputs' ranges
BINARY = {
    "add": ((-3, 3), (-3, 3)), "subtract": ((-3, 3), (-3, 3)),
    "multiply": ((-3, 3), (-3, 3)), "divide": ((-3, 3), (0.5, 3)),
    "floor_divide": ((-9, 9), (0.5, 3)), "remainder": ((-9, 9), (-3, -0.5)),
    "fmod": ((-9, 9), (0.5, 3)), "pow": ((0.1, 3), (-2, 2)),
    "maximum": ((-3, 3), (-3, 3)), "minimum": ((-3, 3), (-3, 3)),
    "fmax": ((-3, 3), (-3, 3)), "fmin": ((-3, 3), (-3, 3)),
    "atan2": ((-3, 3), (-3, 3)), "logaddexp": ((-30, 30), (-30, 30)),
    "logaddexp2": ((-30, 30), (-30, 30)), "heaviside": ((-3, 3), (0, 1)),
    "nextafter": ((-3, 3), (-3, 3)), "copysign": ((-3, 3), (-3, 3)),
    "hypot": ((-3, 3), (-3, 3)),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_matches_jax(name):
    (a, b), (c, d) = BINARY[name]
    x, y = _u(a, b, seed=1), _u(c, d, seed=2)
    if name == "heaviside":
        x[0, :4] = 0.0      # the ties take y
    _close(getattr(ops, name)(torch.from_numpy(x), torch.from_numpy(y)),
           getattr(jm, name)(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("name", ["gcd", "lcm", "floor_divide", "remainder"])
def test_integer_binary_matches_jax(name):
    rng = np.random.default_rng(3)
    x = rng.integers(-40, 40, (32,)).astype(np.int32)
    y = rng.integers(1, 12, (32,)).astype(np.int32)
    got = getattr(ops, name)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(getattr(jm, name)(jnp.asarray(x),
                                                  jnp.asarray(y))))


def test_ldexp_inner_outer_addmm_lerp():
    x, y = _u(-3, 3, (3, 4), 4), _u(-3, 3, (3, 4), 5)
    e = np.random.default_rng(6).integers(-4, 4, (3, 4)).astype(np.int32)
    t = torch.from_numpy
    _close(ops.ldexp(t(x), t(e)), jm.ldexp(jnp.asarray(x), jnp.asarray(e)))
    _close(ops.inner(t(x), t(y)), jm.inner(jnp.asarray(x), jnp.asarray(y)))
    _close(ops.outer(t(x), t(y)), jm.outer(jnp.asarray(x), jnp.asarray(y)))
    m = _u(-1, 1, (3, 3), 7)
    _close(ops.addmm(t(m), t(x), t(y.T.copy()), beta=0.5, alpha=2.0),
           jm.addmm(jnp.asarray(m), jnp.asarray(x), jnp.asarray(y.T),
                    beta=0.5, alpha=2.0))
    w = _u(0, 1, (3, 4), 8)
    _close(ops.lerp(t(x), t(y), t(w)),
           jm.lerp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))


# (name, kwargs): the ops with parameters, each form JAX's tests use
PARAM = [
    ("logit", dict(eps=0.1)), ("round", dict(decimals=2)),
    ("polygamma", dict(n=1)), ("polygamma", dict(n=2)),
    ("polygamma", dict(n=3)),
    ("nan_to_num", dict(nan=1.5, posinf=9.0, neginf=-9.0)),
    ("nan_to_num", dict()),
    ("scale", dict(scale=2.5, bias=0.5)),
    ("scale", dict(scale=2.5, bias=0.5, bias_after_scale=False)),
    ("clip", dict(min=-0.5, max=0.7)), ("clip", dict(min=-0.5)),
    ("clip", dict(max=0.7)), ("clip", dict()),
    ("stanh", dict()), ("stanh", dict(scale_a=0.5, scale_b=2.0)),
    ("diff", dict()), ("diff", dict(n=2, axis=0)),
    ("increment", dict(value=2.5)), ("fill", dict(value=3.0)),
    ("fill_diagonal", dict(value=7.0)),
    ("fill_diagonal", dict(value=7.0, offset=1)),
    ("clip_by_norm", dict(max_norm=1.0)),
    ("clip_by_norm", dict(max_norm=1e3)),
    ("squared_l2_norm", dict()),
    ("renorm", dict(p=2.0, axis=0, max_norm=1.0)),
    ("renorm", dict(p=1.0, axis=1, max_norm=2.0)),
    ("frobenius_norm", dict()),
    ("frobenius_norm", dict(axis=[1], keepdim=True)),
    ("trapezoid", dict(dx=0.5)), ("trapezoid", dict(axis=0)),
]


@pytest.mark.parametrize("name,kw", PARAM,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(PARAM)])
def test_parameterized_ops_match_jax(name, kw):
    x = _u(0.2, 3, (5, 6), 9) if name == "polygamma" else _u(-2, 2, (5, 6))
    if name == "logit":
        x = _u(0.01, 0.99, (5, 6))
    if name == "nan_to_num":
        x[0, :3] = [np.nan, np.inf, -np.inf]
    # polygamma: a series in JAX against a recurrence in torch
    tol = dict(rtol=5e-6, atol=1e-6) if name == "polygamma" else {}
    _close(getattr(ops, name)(torch.from_numpy(x), **kw),
           getattr(jm, name)(jnp.asarray(x), **kw), **tol)


def test_fill_diagonal_wrap_and_trapezoid_x():
    x = _u(-1, 1, (7, 3))
    _close(ops.fill_diagonal(torch.from_numpy(x), value=5.0, wrap=True),
           jm.fill_diagonal(jnp.asarray(x), value=5.0, wrap=True))
    y, xs = _u(-1, 1, (4, 6)), np.sort(_u(0, 3, (6,), 2))
    _close(ops.trapezoid(torch.from_numpy(y), torch.from_numpy(xs)),
           jm.trapezoid(jnp.asarray(y), jnp.asarray(xs)))


def test_gammaincc_multiplex_is_empty():
    a, x = _u(0.1, 6, seed=1), _u(0.1, 6, seed=2)
    # a continued fraction (torch) against a series (JAX)
    _close(ops.gammaincc(torch.from_numpy(a), torch.from_numpy(x)),
           jm.gammaincc(jnp.asarray(a), jnp.asarray(x)), rtol=1e-5,
           atol=5e-6)
    ins = [_u(-1, 1, (4, 3), s) for s in range(3)]
    idx = np.array([[2], [0], [1], [2]], np.int32)
    _close(ops.multiplex([torch.from_numpy(i) for i in ins],
                         torch.from_numpy(idx)),
           jm.multiplex([jnp.asarray(i) for i in ins], jnp.asarray(idx)))
    assert bool(ops.is_empty(torch.zeros(0, 3))) is True
    assert bool(ops.is_empty(torch.zeros(2))) == bool(
        jm.is_empty(jnp.zeros(2)))


def test_rsub_and_square_sum_are_helpers():
    # implemented as in JAX, not exported (JAX's op table lacks them)
    x, y = _u(-1, 1, seed=1), _u(-1, 1, seed=2)
    _close(pm.rsub(torch.from_numpy(x), torch.from_numpy(y)),
           jm.rsub(jnp.asarray(x), jnp.asarray(y)))
    _close(pm.square_sum(torch.from_numpy(x)), jm.square_sum(jnp.asarray(x)),
           rtol=1e-5, atol=1e-5)
    assert "rsub" not in ops.__all__ and "square_sum" not in ops.__all__


GRAD = {
    "lgamma": (0.3, 5), "digamma": (0.3, 5), "erfinv": (-0.9, 0.9),
    "i0": (-3, 3), "i1e": (-3, 3), "logit": (0.05, 0.95),
    "atanh": (-0.9, 0.9), "sinc": (-2, 2), "rsqrt": (0.2, 3),
}


@pytest.mark.parametrize("name", sorted(GRAD))
def test_unary_gradients_match_jax_tape(name):
    x = _u(*GRAD[name], shape=(16,))
    w = _u(-1, 1, (16,), 3)
    t = torch.from_numpy(x).requires_grad_()
    (getattr(ops, name)(t) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(getattr(jm, name)(a) * w))(
        jnp.asarray(x))
    _close(t.grad, want, rtol=1e-5, atol=1e-5)


def test_binary_gradients_match_jax_tape():
    x, y = _u(0.2, 3, (16,), 1), _u(-2, 2, (16,), 2)
    for name in ("pow", "logaddexp", "atan2", "hypot", "divide"):
        tx = torch.from_numpy(x).requires_grad_()
        ty = torch.from_numpy(y).requires_grad_()
        getattr(ops, name)(tx, ty).sum().backward()
        gx, gy = jax.grad(lambda a, b, n=name: jnp.sum(getattr(jm, n)(a, b)),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        _close(tx.grad, gx, rtol=1e-5, atol=1e-5)
        _close(ty.grad, gy, rtol=1e-5, atol=1e-5)


# ---- complex -------------------------------------------------------------
def _z(shape=(3, 5), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_complex_accessors_and_constructors_match_jax():
    z = _z()
    for name in ("real", "imag", "conj", "angle", "abs", "sign"):
        got = getattr(ops, name)(torch.from_numpy(z))
        want = getattr(jm, name)(jnp.asarray(z))
        assert got.dtype == {"conj": torch.complex64,
                             "sign": torch.complex64}.get(name, torch.float32)
        _close(got.resolve_conj(), want)
    re, im = _u(-1, 1, (3, 5), 1), _u(-1, 1, (3, 5), 2)
    _close(ops.complex(torch.from_numpy(re), torch.from_numpy(im)),
           jc.complex(jnp.asarray(re), jnp.asarray(im)))
    pairs = _u(-1, 1, (3, 5, 2), 3)
    _close(ops.as_complex(torch.from_numpy(pairs)),
           jmanip.as_complex(jnp.asarray(pairs)))
    _close(ops.as_real(torch.from_numpy(z)), jmanip.as_real(jnp.asarray(z)))
    assert ops.as_complex is pmanip.as_complex
    # a real input: conj as is, imag zeros, as in JAX
    x = _u(-1, 1)
    _close(ops.conj(torch.from_numpy(x)), jm.conj(jnp.asarray(x)))
    _close(ops.imag(torch.from_numpy(x)), jm.imag(jnp.asarray(x)))


def test_gradient_through_complex_intermediates_matches_jax():
    # real leaves -> complex -> real loss: the same gradient as JAX's tape
    re, im = _u(-1, 1, (8,), 1), _u(-1, 1, (8,), 2)
    w = _z((8,), 3)

    def jax_loss(a, b):
        c = jc.complex(a, b) * jnp.asarray(w)
        return jnp.sum(jm.real(c * jm.conj(c)) + jm.angle(c))

    ta = torch.from_numpy(re).requires_grad_()
    tb = torch.from_numpy(im).requires_grad_()
    c = ops.complex(ta, tb) * torch.from_numpy(w)
    (ops.real(c * ops.conj(c)) + ops.angle(c)).sum().backward()
    ga, gb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(re),
                                                 jnp.asarray(im))
    _close(ta.grad, ga, rtol=1e-5, atol=1e-5)
    _close(tb.grad, gb, rtol=1e-5, atol=1e-5)


def test_gradient_at_a_complex_leaf_is_the_conjugate_of_jax():
    # the port keeps torch's convention at a complex leaf: conj(JAX's)
    z, w = _z((8,)), _u(0.5, 2, (8,))

    def jax_loss(a):
        return jnp.sum(jnp.abs(a) ** 2 * w) + jnp.sum(jm.real(a * (1 + 2j)))

    t = torch.from_numpy(z).requires_grad_()
    ((ops.abs(t) ** 2 * torch.from_numpy(w)).sum()
     + ops.real(t * (1 + 2j)).sum()).backward()
    want = np.conj(np.asarray(jax.grad(jax_loss)(jnp.asarray(z))))
    _close(t.grad, want, rtol=1e-5, atol=1e-5)


def test_abs_of_complex_zero_has_a_finite_gradient():
    z = np.zeros(4, np.complex64)
    t = torch.from_numpy(z).requires_grad_()
    ops.abs(t).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.abs(a)))(jnp.asarray(z))
    assert torch.isfinite(torch.view_as_real(t.grad)).all()
    _close(t.grad, want)


# ---- random ----------------------------------------------------------------
N = 20000


def _moments_close(port, law_mean, law_var, jax_draws=None, k=6.0):
    """Mean within k standard errors of the law's (and of JAX's draws'),
    variance within k standard errors of the law's (4th moment from the
    draws)."""
    a = port.double().numpy().reshape(-1)
    n = a.size
    se = np.sqrt(law_var / n)
    assert abs(a.mean() - law_mean) <= k * se, (a.mean(), law_mean)
    m4 = np.mean((a - a.mean()) ** 4)
    se_var = np.sqrt(max(m4 - a.var() ** 2, 1e-30) / n)
    assert abs(a.var() - law_var) <= k * se_var, (a.var(), law_var)
    if jax_draws is not None:
        b = np.asarray(jax_draws, np.float64).reshape(-1)
        se2 = np.sqrt(a.var() / n + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= k * se2, (a.mean(), b.mean())


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_creation_ops_by_distribution():
    u = ops.uniform([N], min=-2.0, max=3.0, device="cpu", generator=_gen())
    assert u.dtype == torch.float32 and u.device.type == "cpu"
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    _moments_close(u, 0.5, 25 / 12, jax_ops.uniform([N], min=-2.0,
                                                    max=3.0).numpy())
    g = ops.gaussian([N], mean=1.0, std=2.0, device="cpu", generator=_gen())
    _moments_close(g, 1.0, 4.0, jax_ops.gaussian([N], mean=1.0,
                                                 std=2.0).numpy())
    r = ops.randint(3, 10, [N], device="cpu", generator=_gen())
    assert r.dtype == torch.int64 and int(r.min()) == 3 and int(r.max()) == 9
    _moments_close(r, 6.0, (7 ** 2 - 1) / 12,
                   jax_ops.randint(3, 10, [N]).numpy())
    assert int(ops.randint(5, shape=[N], device="cpu").max()) == 4
    p = ops.randperm(50, device="cpu", generator=_gen())
    assert sorted(p.tolist()) == list(range(50))
    assert ops.uniform([2, 3], "float64", device="cpu").dtype == torch.float64


def test_sampling_ops_by_distribution():
    ones = np.ones(N, np.float32)
    t, j = torch.from_numpy, jax_ops
    pb = 0.3 * ones
    _moments_close(ops.bernoulli(t(pb), generator=_gen()), 0.3, 0.21,
                   j.bernoulli(paddle_tpu.to_tensor(pb)).numpy())
    lam = 3.5 * ones
    _moments_close(ops.poisson(t(lam), generator=_gen()), 3.5, 3.5,
                   j.poisson(paddle_tpu.to_tensor(lam)).numpy())
    _moments_close(ops.exponential(t(ones), lam=2.0, generator=_gen()),
                   0.5, 0.25,
                   j.exponential(paddle_tpu.to_tensor(ones), lam=2.0).numpy())
    a = 2.5 * ones
    _moments_close(ops.standard_gamma(t(a), generator=_gen()), 2.5, 2.5,
                   j.standard_gamma(paddle_tpu.to_tensor(a)).numpy())
    n, p = 12.0 * ones, 0.35 * ones
    b = ops.binomial(t(n), t(p), generator=_gen())
    assert b.dtype == torch.int64
    _moments_close(b, 12 * 0.35, 12 * 0.35 * 0.65,
                   j.binomial(paddle_tpu.to_tensor(n),
                              paddle_tpu.to_tensor(p)).numpy())
    alpha = np.array([1.0, 2.0, 3.0], np.float32)
    d = ops.dirichlet(t(np.tile(alpha, (N, 1))), generator=_gen())
    np.testing.assert_allclose(d.sum(-1).numpy(), 1.0, rtol=1e-5)
    _moments_close(d[:, 2], 0.5, 0.5 * 0.5 / 7,
                   j.dirichlet(paddle_tpu.to_tensor(alpha[None].repeat(
                       2000, 0))).numpy()[:, 2])


def test_multinomial_and_exponential_in_16_bits():
    w = np.array([1.0, 3.0, 0.0, 6.0], np.float32)
    draws = ops.multinomial(torch.from_numpy(w), N, True, generator=_gen())
    freq = np.bincount(draws.numpy(), minlength=4) / N
    want = w / w.sum()
    assert np.all(np.abs(freq - want) <= 6 * np.sqrt(want * (1 - want) / N))
    rows = ops.multinomial(torch.from_numpy(np.tile(w, (3, 1))), 3,
                           generator=_gen())
    assert rows.shape == (3, 3) and all(len(set(r)) == 3
                                        for r in rows.tolist())
    assert 2 not in rows.reshape(-1).tolist()
    e = ops.exponential(torch.ones(N, dtype=torch.bfloat16),
                        generator=_gen())
    assert e.dtype == torch.bfloat16
    _moments_close(e.float(), 1.0, 1.0)


def test_one_seed_one_output():
    for fn in (lambda g: ops.uniform([64], device="cpu", generator=g),
               lambda g: ops.gaussian([64], device="cpu", generator=g),
               lambda g: ops.randint(0, 9, [64], device="cpu", generator=g),
               lambda g: ops.poisson(torch.full((64,), 2.0), generator=g),
               lambda g: pr.dirichlet(torch.ones(8, 3), generator=g)):
        assert torch.equal(fn(_gen(7)), fn(_gen(7)))
        assert not torch.equal(fn(_gen(7)), fn(_gen(8)))


@pytest.mark.parametrize("k", [5, 256, 257, 70001])
def test_categorical_draws_scan_in_segments(k):
    # the inverse CDF's scan runs in segments of 256 (and segments of
    # their totals past 256 x 256 classes): the same sums as one scan,
    # within float64 rounding, and every class drawn at its frequency
    w = np.random.default_rng(k).random((2, k)) + 0.5
    cdf = pr._cumsum_rows(torch.from_numpy(w))
    np.testing.assert_allclose(cdf.numpy(), np.cumsum(w, -1), rtol=1e-12)
    hot = np.zeros(k)
    hot[[0, k // 2, k - 1]] = [1.0, 2.0, 5.0]
    draws = ops.multinomial(torch.from_numpy(hot), N, True, generator=_gen())
    assert draws.shape == (N,) and draws.dtype == torch.int64
    freq = np.bincount(draws.numpy(), minlength=k) / N
    want = hot / hot.sum()
    assert np.all(np.abs(freq - want) <= 6 * np.sqrt(want * (1 - want) / N))
    again = ops.multinomial(torch.from_numpy(hot), N, True, generator=_gen())
    assert torch.equal(draws, again)
