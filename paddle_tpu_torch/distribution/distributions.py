"""The distributions and the KL registry (counterpart of
``paddle_tpu/distribution/distributions.py``).

Parameters that are tensors keep their device and their autograd graph:
``log_prob``, ``prob``, ``entropy``, ``rsample`` and ``kl_divergence``
are differentiable with respect to them, and recompute from them on every
call (a second backward works). Parameters that are Python numbers or
numpy arrays become float32 tensors on ``resolve_device(device)``: the
card unless the caller names another device. Parameters on two devices
are refused. The moments (``mean``, ``variance``, ``stddev``) and
``Categorical.probs`` carry no gradient, as in the JAX package.

Draws come from ``generator`` (a ``torch.Generator`` on the parameters'
device), or from that device's default generator, through PyTorch's
samplers (``torch.poisson``, ``torch.binomial``, ``torch._standard_gamma``,
``torch._sample_dirichlet``, and the inverse CDF of
``ops.random._categorical_draws`` for the categorical draws, which gives
one output for one seed where ``torch.multinomial`` over a long row on
the card does not). ``sample`` and
``rsample`` keep the JAX split: where JAX's ``sample`` is the
reparameterized draw it carries gradients; ``Gamma``, ``Beta``,
``Chi2`` and the discrete distributions have no ``rsample``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.random import _categorical_draws

__all__ = [
    "Distribution", "Normal", "Uniform", "Bernoulli", "Categorical",
    "Exponential", "Laplace", "LogNormal", "Gumbel", "Beta", "Gamma",
    "Dirichlet", "Multinomial", "Poisson", "Geometric", "Binomial",
    "Cauchy", "Chi2", "StudentT", "ContinuousBernoulli",
    "MultivariateNormal", "Independent", "TransformedDistribution",
    "kl_divergence", "register_kl",
]

_EULER = float(np.euler_gamma)
_LOG_2PI = math.log(2 * math.pi)


def _same_device(a, b):
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _placed(values, device):
    """The device of ``values``' tensors (all on one), else
    ``resolve_device(device)``."""
    devs = {v.device for v in values if isinstance(v, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"distribution parameters on different devices: "
                         f"{sorted(str(d) for d in devs)}")
    if not devs:
        return resolve_device(device)
    dev = devs.pop()
    if device is not None and not _same_device(torch.device(device), dev):
        raise ValueError(f"parameters on {dev}, device={device!r}")
    return dev


def _tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, int, float)):
        # a fill on the device: no copy from the host, so no host sync
        return torch.full((), v, dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)


# the noise of the reparameterized draws; a test may swap these to feed
# the same noise to two devices
def _randn(shape, like, generator):
    return torch.randn(shape, dtype=like.dtype, device=like.device,
                       generator=generator)


def _rand(shape, like, generator, low=0.0, high=1.0):
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    return out.uniform_(low, high, generator=generator)


class Distribution:
    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    def _params(self, *values, device=None):
        """``values`` as tensors on one device; sets ``_device`` and
        ``_dtype`` (their promoted float dtype)."""
        self._device = _placed(values, device)
        out = [_tensor(v, self._device) for v in values]
        dt = functools.reduce(torch.promote_types, [t.dtype for t in out])
        self._dtype = dt if dt.is_floating_point else torch.float32
        return out

    def _value(self, v):
        return _tensor(v, self._device)

    def _like(self):
        return torch.empty((), dtype=self._dtype, device=self._device)

    def _shape(self, shape):
        return tuple(shape) + self._batch_shape

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def sample(self, shape=(), generator=None):
        raise NotImplementedError

    def rsample(self, shape=(), generator=None):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


def _broadcast(*ts):
    return torch.broadcast_shapes(*[t.shape for t in ts])


class Normal(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = self._params(loc, scale, device=device)
        super().__init__(_broadcast(self.loc, self.scale))

    @property
    def mean(self):
        return self.loc.detach().expand(self._batch_shape)

    @property
    def variance(self):
        return torch.square(self.scale.detach()).expand(self._batch_shape)

    @property
    def stddev(self):
        return self.scale.detach().expand(self._batch_shape)

    def rsample(self, shape=(), generator=None):
        eps = _randn(self._shape(shape), self._like(), generator)
        return self.loc + self.scale * eps

    sample = rsample        # reparameterized by construction

    def log_prob(self, value):
        v = self._value(value)
        return (-torch.square(v - self.loc) / (2 * torch.square(self.scale))
                - torch.log(self.scale) - 0.5 * _LOG_2PI)

    def entropy(self):
        return (0.5 + 0.5 * _LOG_2PI + torch.log(self.scale)).expand(
            self._batch_shape)


class Uniform(Distribution):
    def __init__(self, low, high, name=None, *, device=None):
        self.low, self.high = self._params(low, high, device=device)
        super().__init__(_broadcast(self.low, self.high))

    def rsample(self, shape=(), generator=None):
        u = _rand(self._shape(shape), self._like(), generator)
        return self.low + (self.high - self.low) * u

    sample = rsample

    def log_prob(self, value):
        v = self._value(value)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)

    @property
    def mean(self):
        return ((self.low + self.high) / 2).detach()

    @property
    def variance(self):
        return (torch.square(self.high - self.low) / 12).detach()


def _clip_p(p):
    return torch.clamp(p, 1e-7, 1 - 1e-7)


class Bernoulli(Distribution):
    def __init__(self, probs, name=None, *, device=None):
        (self.probs,) = self._params(probs, device=device)
        super().__init__(self.probs.shape)

    def sample(self, shape=(), generator=None):
        p = self.probs.detach().expand(self._shape(shape))
        return torch.bernoulli(p.float(), generator=generator)

    def log_prob(self, value):
        v = self._value(value)
        p = _clip_p(self.probs)
        return v * torch.log(p) + (1 - v) * torch.log1p(-p)

    def entropy(self):
        p = _clip_p(self.probs)
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))

    @property
    def mean(self):
        return self.probs.detach()

    @property
    def variance(self):
        p = self.probs.detach()
        return p * (1 - p)


def _log_probs(probs):
    return torch.log(torch.clamp(probs, min=1e-12))


class Categorical(Distribution):
    """Over the last axis of ``logits`` (or of ``probs``, logits
    log(max(probs, 1e-12)))."""

    def __init__(self, logits=None, probs=None, name=None, *, device=None):
        if logits is None and probs is None:
            raise ValueError("provide logits or probs")
        self._from_logits = logits is not None
        (self._param,) = self._params(
            logits if self._from_logits else probs, device=device)
        super().__init__(self._param.shape[:-1])

    def _logits(self):
        return self._param if self._from_logits else _log_probs(self._param)

    @property
    def logits(self):
        return self._logits().detach()

    @property
    def probs(self):
        return torch.softmax(self.logits, -1)

    def sample(self, shape=(), generator=None):
        """Class ids, int64, [*shape, *batch_shape]."""
        k = self._param.shape[-1]
        n = math.prod(shape)
        draws = _categorical_draws(self.probs.reshape(-1, k), n, generator)
        return draws.T.reshape(self._shape(shape))

    def log_prob(self, value):
        logp = torch.log_softmax(self._logits(), -1)
        vi = self._value(value).long()
        out_shape = torch.broadcast_shapes(vi.shape, logp.shape[:-1])
        logp = logp.expand(out_shape + logp.shape[-1:])
        return torch.gather(logp, -1, vi.expand(out_shape)[..., None])[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self._logits(), -1)
        return -torch.sum(torch.exp(logp) * logp, -1)


class Exponential(Distribution):
    def __init__(self, rate, name=None, *, device=None):
        (self.rate,) = self._params(rate, device=device)
        super().__init__(self.rate.shape)

    def rsample(self, shape=(), generator=None):
        e = -torch.log1p(-_rand(self._shape(shape), self._like(), generator))
        return e / self.rate

    sample = rsample

    def log_prob(self, value):
        return torch.log(self.rate) - self.rate * self._value(value)

    def entropy(self):
        return 1.0 - torch.log(self.rate)

    @property
    def mean(self):
        return 1.0 / self.rate.detach()

    @property
    def variance(self):
        return 1.0 / torch.square(self.rate.detach())


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = self._params(loc, scale, device=device)
        super().__init__(_broadcast(self.loc, self.scale))

    def rsample(self, shape=(), generator=None):
        like = self._like()
        u = _rand(self._shape(shape), like, generator,
                  torch.finfo(like.dtype).eps - 1, 1.0)
        eps = -torch.sign(u) * torch.log1p(-torch.abs(u))
        return self.loc + self.scale * eps

    sample = rsample

    def log_prob(self, value):
        v = self._value(value)
        return -torch.abs(v - self.loc) / self.scale - torch.log(
            2 * self.scale)

    def entropy(self):
        return 1 + torch.log(2 * self.scale)

    @property
    def mean(self):
        return self.loc.detach()

    @property
    def variance(self):
        return 2 * torch.square(self.scale.detach())


class LogNormal(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = self._params(loc, scale, device=device)
        super().__init__(_broadcast(self.loc, self.scale))

    def rsample(self, shape=(), generator=None):
        eps = _randn(self._shape(shape), self._like(), generator)
        return torch.exp(self.loc + self.scale * eps)

    sample = rsample

    def log_prob(self, value):
        v = self._value(value)
        return (-torch.square(torch.log(v) - self.loc)
                / (2 * torch.square(self.scale))
                - torch.log(self.scale) - 0.5 * _LOG_2PI - torch.log(v))

    @property
    def mean(self):
        return torch.exp(self.loc + torch.square(self.scale) / 2).detach()

    @property
    def variance(self):
        s2 = torch.square(self.scale.detach())
        return (torch.exp(s2) - 1) * torch.exp(2 * self.loc.detach() + s2)

    def entropy(self):
        return 0.5 + 0.5 * _LOG_2PI + torch.log(self.scale) + self.loc


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = self._params(loc, scale, device=device)
        super().__init__(_broadcast(self.loc, self.scale))

    def rsample(self, shape=(), generator=None):
        like = self._like()
        fi = torch.finfo(like.dtype)
        u = _rand(self._shape(shape), like, generator, fi.tiny, 1.0 - fi.eps)
        return self.loc + self.scale * -torch.log(-torch.log(u))

    sample = rsample

    def log_prob(self, value):
        z = (self._value(value) - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    @property
    def mean(self):
        return (self.loc + self.scale * _EULER).detach()

    @property
    def variance(self):
        return (torch.square(self.scale) * (math.pi ** 2) / 6).detach()

    def entropy(self):
        return torch.log(self.scale) + 1 + _EULER


def _gamma_draws(conc, shape, generator):
    return torch._standard_gamma(conc.detach().expand(shape).contiguous(),
                                 generator=generator)


class Gamma(Distribution):
    def __init__(self, concentration, rate, name=None, *, device=None):
        self.concentration, self.rate = self._params(concentration, rate,
                                                     device=device)
        super().__init__(_broadcast(self.concentration, self.rate))

    def sample(self, shape=(), generator=None):
        """Differentiable in ``rate`` only, as in JAX."""
        g = _gamma_draws(self.concentration, self._shape(shape), generator)
        return g / self.rate

    def log_prob(self, value):
        a, b, v = self.concentration, self.rate, self._value(value)
        return (a * torch.log(b) + (a - 1) * torch.log(v) - b * v
                - torch.special.gammaln(a))

    @property
    def mean(self):
        return (self.concentration / self.rate).detach()

    @property
    def variance(self):
        return (self.concentration / torch.square(self.rate)).detach()

    def entropy(self):
        a, b = self.concentration, self.rate
        return (a - torch.log(b) + torch.special.gammaln(a)
                + (1 - a) * torch.special.digamma(a))


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None, *, device=None):
        self.alpha, self.beta = self._params(alpha, beta, device=device)
        super().__init__(_broadcast(self.alpha, self.beta))

    def sample(self, shape=(), generator=None):
        shp = self._shape(shape)
        ab = torch.stack([self.alpha.detach().expand(shp),
                          self.beta.detach().expand(shp)], -1)
        return torch._sample_dirichlet(ab, generator=generator)[..., 0]

    def log_prob(self, value):
        a, b, v = self.alpha, self.beta, self._value(value)
        lg = torch.special.gammaln
        return ((a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
                - (lg(a) + lg(b) - lg(a + b)))

    @property
    def mean(self):
        return (self.alpha / (self.alpha + self.beta)).detach()

    @property
    def variance(self):
        a, b = self.alpha.detach(), self.beta.detach()
        s = a + b
        return a * b / (torch.square(s) * (s + 1))


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None, *, device=None):
        (self.concentration,) = self._params(concentration, device=device)
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    def sample(self, shape=(), generator=None):
        conc = self.concentration.detach()
        shp = self._shape(shape) + self._event_shape
        return torch._sample_dirichlet(conc.expand(shp).contiguous(),
                                       generator=generator)

    def log_prob(self, value):
        a, v = self.concentration, self._value(value)
        lg = torch.special.gammaln
        return (torch.sum((a - 1) * torch.log(v), -1)
                - (torch.sum(lg(a), -1) - lg(torch.sum(a, -1))))

    @property
    def mean(self):
        a = self.concentration.detach()
        return a / torch.sum(a, -1, keepdim=True)


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None, *, device=None):
        self.total_count = int(total_count)
        (self.probs,) = self._params(probs, device=device)
        super().__init__(self.probs.shape[:-1], self.probs.shape[-1:])

    def sample(self, shape=(), generator=None):
        """Counts per class, float32, [*shape, *batch_shape, k]."""
        k = self.probs.shape[-1]
        n = math.prod(shape)
        rows = torch.clamp(self.probs.detach(), min=1e-12).reshape(-1, k)
        draws = _categorical_draws(rows, n * self.total_count, generator)
        counts = torch.zeros(rows.shape[0], n, k, dtype=torch.float32,
                             device=rows.device)
        counts.scatter_add_(
            2, draws.reshape(rows.shape[0], n, self.total_count),
            torch.ones((), dtype=torch.float32, device=rows.device).expand(
                rows.shape[0], n, self.total_count))
        return counts.transpose(0, 1).reshape(
            self._shape(shape) + (k,))

    def log_prob(self, value):
        v = self._value(value)
        return (math.lgamma(self.total_count + 1.0)
                - torch.sum(torch.special.gammaln(v + 1.0), -1)
                + torch.sum(v * _log_probs(self.probs), -1))

    @property
    def mean(self):
        return self.total_count * self.probs.detach()


# ---- the KL registry -------------------------------------------------------
_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn

    return deco


def kl_divergence(p, q):
    for (pc, qc), fn in _KL_REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            return fn(p, q)
    raise NotImplementedError(
        f"no KL registered for ({type(p).__name__}, {type(q).__name__})")


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    r = torch.square(p.scale / q.scale)
    return 0.5 * (r + torch.square((p.loc - q.loc) / q.scale) - 1
                  - torch.log(r))


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    return torch.log((q.high - q.low) / (p.high - p.low))


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    pc, qc = _clip_p(p.probs), _clip_p(q.probs)
    return (pc * (torch.log(pc) - torch.log(qc))
            + (1 - pc) * (torch.log1p(-pc) - torch.log1p(-qc)))


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    logp = torch.log_softmax(p._logits(), -1)
    logq = torch.log_softmax(q._logits(), -1)
    return torch.sum(torch.exp(logp) * (logp - logq), -1)


@register_kl(Exponential, Exponential)
def _kl_exponential(p, q):
    return torch.log(p.rate) - torch.log(q.rate) + q.rate / p.rate - 1


# ---- the rest of the family ------------------------------------------------
class Poisson(Distribution):
    def __init__(self, rate, name=None, *, device=None):
        (self.rate,) = self._params(rate, device=device)
        super().__init__(self.rate.shape)

    @property
    def mean(self):
        return self.rate.detach()

    @property
    def variance(self):
        return self.rate.detach()

    def sample(self, shape=(), generator=None):
        """float32 counts."""
        r = self.rate.detach().expand(self._shape(shape)).contiguous()
        return torch.poisson(r, generator=generator).float()

    def log_prob(self, value):
        v = self._value(value)
        return v * torch.log(self.rate) - self.rate - torch.special.gammaln(
            v + 1.0)

    def entropy(self):
        """Below rate 16 the exact sum over k < 64 (the tail past it is
        negligible there), above it the asymptotic series."""
        r = self.rate
        ks = torch.arange(64.0, dtype=r.dtype, device=r.device).reshape(
            (64,) + (1,) * r.dim())
        logp = ks * torch.log(r) - r - torch.special.gammaln(ks + 1.0)
        exact = -torch.sum(torch.exp(logp) * logp, 0)
        series = (0.5 * torch.log(2 * math.pi * math.e * r)
                  - 1 / (12 * r) - 1 / (24 * r ** 2))
        return torch.where(r < 16.0, exact, series)


class Geometric(Distribution):
    """P(X = k) = (1 - p)^k p, k = 0, 1, ... (failures before the first
    success)."""

    def __init__(self, probs, name=None, *, device=None):
        (self.probs,) = self._params(probs, device=device)
        super().__init__(self.probs.shape)

    @property
    def mean(self):
        p = self.probs.detach()
        return (1.0 - p) / p

    @property
    def variance(self):
        p = self.probs.detach()
        return (1.0 - p) / torch.square(p)

    def sample(self, shape=(), generator=None):
        u = _rand(self._shape(shape), self._like(), generator, 1e-7, 1.0)
        return torch.floor(torch.log(u) / torch.log1p(-self.probs.detach()))

    def log_prob(self, value):
        p = self.probs
        return self._value(value) * torch.log1p(-p) + torch.log(p)

    def entropy(self):
        p = self.probs
        return (-(1 - p) * torch.log1p(-p) - p * torch.log(p)) / p


class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None, *, device=None):
        count, self.probs = self._params(total_count, probs, device=device)
        # a constant of the gradient, as in JAX
        self.total_count = count.detach().to(self.probs.dtype)
        super().__init__(_broadcast(self.total_count, self.probs))

    @property
    def mean(self):
        return self.total_count * self.probs.detach()

    @property
    def variance(self):
        p = self.probs.detach()
        return self.total_count * p * (1 - p)

    def sample(self, shape=(), generator=None):
        """float32 counts."""
        shp = self._shape(shape)
        p = self.probs.detach().float()
        return torch.binomial(self.total_count.float().expand(shp)
                              .contiguous(), p.expand(shp).contiguous(),
                              generator=generator)

    def log_prob(self, value):
        n, p, v = self.total_count, self.probs, self._value(value)
        lg = torch.special.gammaln
        logc = lg(n + 1) - lg(v + 1) - lg(n - v + 1)
        return logc + v * torch.log(p) + (n - v) * torch.log1p(-p)


class Cauchy(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = self._params(loc, scale, device=device)
        super().__init__(_broadcast(self.loc, self.scale))

    def sample(self, shape=(), generator=None):
        return self.rsample(shape, generator)

    def rsample(self, shape=(), generator=None):
        like = self._like()
        eps = torch.empty(self._shape(shape), dtype=like.dtype,
                          device=like.device).cauchy_(generator=generator)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (self._value(value) - self.loc) / self.scale
        return -torch.log(math.pi * self.scale) - torch.log1p(torch.square(z))

    def entropy(self):
        return torch.log(4 * math.pi * self.scale)


class Chi2(Distribution):
    """Gamma(df / 2, rate 1 / 2)."""

    def __init__(self, df, name=None, *, device=None):
        (self.df,) = self._params(df, device=device)
        super().__init__(self.df.shape)

    @property
    def mean(self):
        return self.df.detach()

    @property
    def variance(self):
        return 2.0 * self.df.detach()

    def sample(self, shape=(), generator=None):
        return 2.0 * _gamma_draws(self.df / 2.0, self._shape(shape),
                                  generator)

    def log_prob(self, value):
        d, v = self.df, self._value(value)
        return ((d / 2 - 1) * torch.log(v) - v / 2 - (d / 2) * math.log(2.0)
                - torch.special.gammaln(d / 2))


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0, name=None, *, device=None):
        self.df, self.loc, self.scale = self._params(df, loc, scale,
                                                     device=device)
        super().__init__(_broadcast(self.df, self.loc, self.scale))

    def sample(self, shape=(), generator=None):
        """loc + scale * t, differentiable in loc and scale (t = z /
        sqrt(chi2(df) / df))."""
        shp = self._shape(shape)
        df = self.df.detach()
        z = _randn(shp, self._like(), generator)
        chi2 = 2.0 * _gamma_draws(df / 2.0, shp, generator)
        t = z * torch.rsqrt(chi2 / df)
        return self.loc + self.scale * t

    def log_prob(self, value):
        d, l, s = self.df, self.loc, self.scale
        z = (self._value(value) - l) / s
        lg = torch.special.gammaln
        return (lg((d + 1) / 2) - lg(d / 2) - 0.5 * torch.log(d * math.pi)
                - torch.log(s)
                - (d + 1) / 2 * torch.log1p(torch.square(z) / d))


class ContinuousBernoulli(Distribution):
    """Density p^x (1 - p)^(1 - x) C(p) on [0, 1], C(p) = 2 atanh(1 - 2p) /
    (1 - 2p), a second-order Taylor form of log C inside ``lims``."""

    def __init__(self, probs, lims=(0.499, 0.501), name=None, *,
                 device=None):
        (self.probs,) = self._params(probs, device=device)
        self._lims = lims
        super().__init__(self.probs.shape)

    def _log_C(self, p):
        outside = (p < self._lims[0]) | (p > self._lims[1])
        safe = torch.where(outside, p, torch.full_like(p, 0.25))
        logc = torch.log(2 * torch.atanh(1 - 2 * safe) / (1 - 2 * safe))
        taylor = math.log(2.0) + 4.0 / 3.0 * torch.square(p - 0.5)
        return torch.where(outside, logc, taylor)

    def sample(self, shape=(), generator=None):
        """The inverse CDF of u in [1e-6, 1 - 1e-6); no gradient."""
        p = self.probs.detach()
        u = _rand(self._shape(shape), self._like(), generator, 1e-6,
                  1 - 1e-6)
        mid = torch.abs(p - 0.5) < 1e-4
        safe = torch.where(mid, torch.full_like(p, 0.25), p)
        icdf = torch.log1p(u * (2 * safe - 1) / (1 - safe)) / (
            torch.log(safe) - torch.log1p(-safe))
        return torch.where(mid, u, icdf)

    def log_prob(self, value):
        p, v = self.probs, self._value(value)
        return v * torch.log(p) + (1 - v) * torch.log1p(-p) + self._log_C(p)


class MultivariateNormal(Distribution):
    """Full covariance through its Cholesky factor: exactly one of
    ``covariance_matrix`` or ``scale_tril``."""

    def __init__(self, loc, covariance_matrix=None, scale_tril=None,
                 name=None, *, device=None):
        if (covariance_matrix is None) == (scale_tril is None):
            raise ValueError(
                "provide exactly one of covariance_matrix / scale_tril")
        self._from_cov = scale_tril is None
        self.loc, self._scale_in = self._params(
            loc, covariance_matrix if self._from_cov else scale_tril,
            device=device)
        raw = self._scale_in.detach()
        self.scale_tril = torch.linalg.cholesky(raw) if self._from_cov \
            else raw
        super().__init__(self.loc.shape[:-1])
        self._event = self.loc.shape[-1]

    def _tril(self):
        """The factor, on the graph of the given matrix (no host check:
        the constructor's ``cholesky`` checked it)."""
        if not self._from_cov:
            return self._scale_in
        return torch.linalg.cholesky_ex(self._scale_in).L

    @property
    def mean(self):
        return self.loc.detach()

    @property
    def variance(self):
        return torch.sum(torch.square(self.scale_tril), -1)

    def sample(self, shape=(), generator=None):
        return self.rsample(shape, generator)

    def rsample(self, shape=(), generator=None):
        eps = _randn(tuple(shape) + tuple(self.loc.shape), self._like(),
                     generator)
        return self.loc + torch.einsum("...ij,...j->...i", self._tril(), eps)

    def log_prob(self, value):
        L = self._tril()
        diff = self._value(value) - self.loc
        bshape = torch.broadcast_shapes(L.shape[:-2], diff.shape[:-1])
        Lb = L.expand(bshape + L.shape[-2:])
        db = diff.expand(bshape + diff.shape[-1:])
        sol = torch.linalg.solve_triangular(Lb, db[..., None],
                                            upper=False)[..., 0]
        logdet = torch.sum(torch.log(torch.diagonal(Lb, dim1=-2, dim2=-1)),
                           -1)
        k = diff.shape[-1]
        return (-0.5 * torch.sum(torch.square(sol), -1) - logdet
                - 0.5 * k * _LOG_2PI)

    def entropy(self):
        logdet = torch.sum(torch.log(torch.diagonal(
            self._tril(), dim1=-2, dim2=-1)), -1)
        return 0.5 * self._event * (1 + _LOG_2PI) + logdet


class Independent(Distribution):
    """``base`` with its last ``reinterpreted_batch_rank`` batch axes read
    as event axes."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self._device, self._dtype = base._device, base._dtype
        self.rank = int(reinterpreted_batch_rank)
        bshape = tuple(base.batch_shape)
        super().__init__(bshape[: len(bshape) - self.rank])

    def sample(self, shape=(), generator=None):
        return self.base.sample(shape, generator)

    def rsample(self, shape=(), generator=None):
        return self.base.rsample(shape, generator)

    def _sum(self, t):
        return torch.sum(t, list(range(t.dim() - self.rank, t.dim())))

    def log_prob(self, value):
        return self._sum(self.base.log_prob(value))

    def entropy(self):
        return self._sum(self.base.entropy())


class TransformedDistribution(Distribution):
    """``base`` pushed through ``transforms``, in order."""

    def __init__(self, base, transforms):
        self.base = base
        self._device, self._dtype = base._device, base._dtype
        if not isinstance(transforms, (list, tuple)):
            transforms = [transforms]
        self.transforms = list(transforms)
        super().__init__(tuple(base.batch_shape))

    def sample(self, shape=(), generator=None):
        x = self.base.sample(shape, generator)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def rsample(self, shape=(), generator=None):
        x = self.base.rsample(shape, generator)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def log_prob(self, value):
        y = self._value(value)
        lp = None
        for t in reversed(self.transforms):
            x = t.inverse(y)
            ld = t.forward_log_det_jacobian(x)
            lp = ld if lp is None else lp + ld
            y = x
        base_lp = self.base.log_prob(y)
        return base_lp - (lp if lp is not None else 0.0)
