"""Random ops (counterpart of ``paddle_tpu/ops/impl/random.py``).

The JAX package splits a key from its default generator for each call;
here each op draws from ``generator`` (a ``torch.Generator`` on the
output's device), or from that device's default generator when it is
None, as the port's dropouts do. The creation ops (``uniform``,
``gaussian``, ``randint``, ``randperm``) place their output by
``resolve_device(device)``: the card unless the caller names another
device. The others draw on their input's device.

Integer results are int64 where the JAX package, with x64 off, gives
int32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.dtype import to_torch

__all__ = [
    "uniform", "gaussian", "randint", "randperm", "bernoulli",
    "multinomial", "poisson", "exponential", "standard_gamma", "binomial",
    "dirichlet",
]

def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return [int(v) for v in shape.reshape(-1).tolist()]
    if isinstance(shape, int):
        return [shape]
    return [int(v) for v in shape]


def uniform(shape, dtype=None, min=-1.0, max=1.0, *, device=None,
            generator=None):
    """Uniform in [min, max)."""
    out = torch.empty(_shape(shape), dtype=to_torch(dtype, torch.float32),
                      device=resolve_device(device))
    return out.uniform_(min, max, generator=generator)


def gaussian(shape, dtype=None, mean=0.0, std=1.0, *, device=None,
             generator=None):
    z = torch.randn(_shape(shape), dtype=to_torch(dtype, torch.float32),
                    device=resolve_device(device), generator=generator)
    return mean + std * z


def randint(low=0, high=None, shape=(1,), dtype="int64", *, device=None,
            generator=None):
    """Integers in [low, high); with ``high`` None, in [0, low)."""
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, _shape(shape), dtype=to_torch(dtype),
                         device=resolve_device(device), generator=generator)


def randperm(n, dtype="int64", *, device=None, generator=None):
    return torch.randperm(int(n), dtype=to_torch(dtype),
                          device=resolve_device(device), generator=generator)


def bernoulli(x, *, generator=None):
    """1 with chance ``x``, else 0, in ``x``'s dtype."""
    return torch.bernoulli(x, generator=generator)


_SCAN_SEGMENT = 256


def _cumsum_rows(p):
    """Inclusive prefix sums along the last axis of ``p`` [rows, k], the
    same bits on every run. On the card a scan of one long row takes
    CUB's decoupled look-back, whose float sums group differently from
    run to run; here every scan is of segments of at most 256, then of
    the segments' totals."""
    rows, k = p.shape
    if k <= _SCAN_SEGMENT:
        return torch.cumsum(p, -1)
    nb = -(-k // _SCAN_SEGMENT)
    seg = F.pad(p, (0, nb * _SCAN_SEGMENT - k)).reshape(
        rows, nb, _SCAN_SEGMENT)
    within = torch.cumsum(seg, -1)
    totals = within[..., -1]
    carry = _cumsum_rows(totals) - totals            # exclusive
    return (within + carry[..., None]).reshape(rows, -1)[:, :k]


def _categorical_draws(weights, n, generator=None):
    """``n`` class ids [rows, n] (int64) for each row of the unnormalized
    ``weights`` [rows, k], with replacement, by the inverse CDF (as
    ``jax.random.choice`` draws): one seed gives one output, and nothing
    synchronizes with the host (``torch.multinomial`` does neither for a
    long row on the card)."""
    cdf = _cumsum_rows(weights.double()).contiguous()
    u = torch.rand(weights.shape[0], n, dtype=torch.float64,
                   device=weights.device, generator=generator)
    ids = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    return ids.clamp_max_(weights.shape[-1] - 1)


def multinomial(x, num_samples=1, replacement=False, *, generator=None):
    """``num_samples`` class ids per row of the (unnormalized) weights
    ``x`` ([k] or [rows, k]); with replacement by the inverse CDF
    (``_categorical_draws``), without it ``torch.multinomial``."""
    if not replacement:
        return torch.multinomial(x, num_samples, False, generator=generator)
    rows = x.reshape(-1, x.shape[-1])
    return _categorical_draws(rows, num_samples, generator).reshape(
        x.shape[:-1] + (num_samples,))


def poisson(x, *, generator=None):
    return torch.poisson(x, generator=generator)


def exponential(x, lam=1.0, *, generator=None):
    """Exp(lam) draws shaped like ``x``: -log(u) / lam with u uniform in
    [1e-7, 1), drawn in float32 for a 16-bit ``x``."""
    dt = x.dtype if x.dtype in (torch.float32, torch.float64) \
        else torch.float32
    u = torch.empty(x.shape, dtype=dt, device=x.device)
    u.uniform_(1e-7, 1.0, generator=generator)
    return (-torch.log(u) / lam).to(x.dtype)


def standard_gamma(x, *, generator=None):
    """Gamma(x, 1) draws."""
    return torch._standard_gamma(x, generator=generator)


def binomial(count, prob, *, generator=None):
    """Binomial(count, prob) draws, element by element (int64)."""
    count, prob = torch.broadcast_tensors(count, prob)
    p = prob.float() if prob.dtype != torch.float64 else prob
    return torch.binomial(count.to(p.dtype), p,
                          generator=generator).to(torch.int64)


def dirichlet(alpha, *, generator=None):
    """Dirichlet draws over the last axis of ``alpha`` (float32)."""
    return torch._sample_dirichlet(alpha.float(), generator=generator)
