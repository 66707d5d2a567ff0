"""Distribution transforms (counterpart of
``paddle_tpu/distribution/transform.py``): bijections y = f(x) with
forward, inverse, log |det J| in either direction and event shapes, in
torch ops on the input's device and autograd graph. A parameter given as
a number (``AffineTransform``'s loc and scale, ``PowerTransform``'s
power) meets each input on that input's device."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device

__all__ = [
    "Transform",
    "AbsTransform",
    "AffineTransform",
    "ChainTransform",
    "ExpTransform",
    "IndependentTransform",
    "PowerTransform",
    "ReshapeTransform",
    "SigmoidTransform",
    "SoftmaxTransform",
    "StackTransform",
    "StickBreakingTransform",
    "TanhTransform",
]


def _t(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float32),
                           device=resolve_device())


def _on(v, x):
    """A parameter ``v`` beside the input ``x`` (a number is a fill on
    ``x``'s device, no copy from the host)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    return torch.as_tensor(np.asarray(v, dtype=np.float32), dtype=x.dtype,
                           device=x.device)


def _sum_last(t, n):
    return torch.sum(t, list(range(t.dim() - n, t.dim()))) if n else t


class Transform:
    """y = f(x) with log |det J| bookkeeping. A subclass gives
    ``_forward``/``_inverse`` and one of the log-det directions; the
    event ranks say how many trailing axes one event spans on each side."""

    _domain_event_rank = 0
    _codomain_event_rank = 0
    bijective = True

    def forward(self, x):
        return self._forward(_t(x))

    def inverse(self, y):
        return self._inverse(_t(y))

    def forward_log_det_jacobian(self, x):
        x = _t(x)
        if hasattr(self, "_forward_log_det_jacobian"):
            return self._forward_log_det_jacobian(x)
        return -self._inverse_log_det_jacobian(self._forward(x))

    def inverse_log_det_jacobian(self, y):
        y = _t(y)
        if hasattr(self, "_inverse_log_det_jacobian"):
            return self._inverse_log_det_jacobian(y)
        return -self._forward_log_det_jacobian(self._inverse(y))

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)

    def __call__(self, x):
        return self.forward(x)


class AbsTransform(Transform):
    """y = |x|; not bijective: the inverse is the positive branch."""

    bijective = False

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def _forward(self, x):
        return _on(self.loc, x) + _on(self.scale, x) * x

    def _inverse(self, y):
        return (y - _on(self.loc, y)) / _on(self.scale, y)

    def _forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(_on(self.scale, x).expand(x.shape)))


class ExpTransform(Transform):
    """y = exp(x)."""

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class PowerTransform(Transform):
    """y = x ** power on the positive half-line."""

    def __init__(self, power):
        self.power = power

    def _forward(self, x):
        return torch.pow(x, _on(self.power, x))

    def _inverse(self, y):
        return torch.pow(y, 1.0 / _on(self.power, y))

    def _forward_log_det_jacobian(self, x):
        p = _on(self.power, x)
        return torch.log(torch.abs(p * torch.pow(x, p - 1.0)))


class SigmoidTransform(Transform):
    """y = sigmoid(x)."""

    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        # log sigmoid'(x) = -softplus(-x) - softplus(x)
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    """y = tanh(x)."""

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        # log(1 - tanh^2 x) = 2 (log 2 - x - softplus(-2x))
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    """y = softmax(x) over the last axis; not bijective onto the simplex:
    the inverse is log, up to an additive constant."""

    bijective = False
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        return torch.softmax(x, -1)

    def _inverse(self, y):
        return torch.log(y)


def _offset(n, like):
    """log(n - i) for i < n: the stick-breaking shift."""
    return torch.log(torch.arange(n, 0, -1, dtype=like.dtype,
                                  device=like.device))


class StickBreakingTransform(Transform):
    """R^n -> the interior of the n-simplex (n + 1 entries) by stick
    breaking."""

    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        z = torch.sigmoid(x - _offset(x.shape[-1], x))
        one = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        rema = torch.cumprod(torch.cat([one, 1.0 - z], -1), -1)
        return torch.cat([z, one], -1) * rema

    def _inverse(self, y):
        n = y.shape[-1] - 1
        cum = torch.cumsum(y, -1)
        zero = torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype,
                           device=y.device)
        lower = torch.cat([zero, cum[..., :-1]], -1)[..., :n]
        z = y[..., :n] / (1.0 - lower)
        return torch.log(z) - torch.log1p(-z) + _offset(n, y)

    def _forward_log_det_jacobian(self, x):
        xo = x - _offset(x.shape[-1], x)
        z = torch.sigmoid(xo)
        one = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        rema = torch.cumprod(torch.cat([one, 1.0 - z], -1), -1)[..., :-1]
        # dy_i / dz_i = the stick left before i; dz / dx = sigmoid'(xo)
        return torch.sum(torch.log(rema) - F.softplus(-xo) - F.softplus(xo),
                         -1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)


class ReshapeTransform(Transform):
    """Reshape the trailing event axes."""

    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(int(s) for s in in_event_shape)
        self.out_event_shape = tuple(int(s) for s in out_event_shape)
        if math.prod(self.in_event_shape) != math.prod(self.out_event_shape):
            raise ValueError(
                f"in_event_shape {in_event_shape} and out_event_shape "
                f"{out_event_shape} have different sizes")
        self._domain_event_rank = len(self.in_event_shape)
        self._codomain_event_rank = len(self.out_event_shape)

    @staticmethod
    def _batch(x, rank):
        return tuple(x.shape[: x.dim() - rank])

    def _forward(self, x):
        return x.reshape(self._batch(x, len(self.in_event_shape))
                         + self.out_event_shape)

    def _inverse(self, y):
        return y.reshape(self._batch(y, len(self.out_event_shape))
                         + self.in_event_shape)

    def _forward_log_det_jacobian(self, x):
        return torch.zeros(self._batch(x, len(self.in_event_shape)),
                           dtype=x.dtype, device=x.device)

    def forward_shape(self, shape):
        r = len(self.in_event_shape)
        return tuple(shape[:len(shape) - r]) + self.out_event_shape

    def inverse_shape(self, shape):
        r = len(self.out_event_shape)
        return tuple(shape[:len(shape) - r]) + self.in_event_shape


class IndependentTransform(Transform):
    """``base`` with ``reinterpreted_batch_rank`` more trailing axes in an
    event: the log-det sums them out."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.rank = int(reinterpreted_batch_rank)
        self._domain_event_rank = base._domain_event_rank + self.rank
        self._codomain_event_rank = base._codomain_event_rank + self.rank

    def _forward(self, x):
        return self.base.forward(x)

    def _inverse(self, y):
        return self.base.inverse(y)

    def _forward_log_det_jacobian(self, x):
        return _sum_last(self.base.forward_log_det_jacobian(x), self.rank)

    def forward_shape(self, shape):
        return self.base.forward_shape(shape)

    def inverse_shape(self, shape):
        return self.base.inverse_shape(shape)


class ChainTransform(Transform):
    """t_n o ... o t_1."""

    def __init__(self, transforms):
        self.transforms = list(transforms)
        self.bijective = all(t.bijective for t in self.transforms)
        self._domain_event_rank = max(
            (t._domain_event_rank for t in self.transforms), default=0)
        self._codomain_event_rank = max(
            (t._codomain_event_rank for t in self.transforms), default=0)

    def _forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def _forward_log_det_jacobian(self, x):
        ld = None
        event_rank = self._domain_event_rank
        for t in self.transforms:
            part = _sum_last(t.forward_log_det_jacobian(x),
                             max(event_rank - t._domain_event_rank, 0))
            ld = part if ld is None else ld + part
            event_rank += t._codomain_event_rank - t._domain_event_rank
            x = t.forward(x)
        return ld

    def forward_shape(self, shape):
        for t in self.transforms:
            shape = t.forward_shape(shape)
        return shape

    def inverse_shape(self, shape):
        for t in reversed(self.transforms):
            shape = t.inverse_shape(shape)
        return shape


class StackTransform(Transform):
    """``transforms[i]`` on slice i along ``axis``."""

    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = int(axis)

    def _map(self, x, method):
        parts = torch.unbind(x, self.axis)
        return torch.stack([getattr(t, method)(p)
                            for t, p in zip(self.transforms, parts)],
                           self.axis)

    def _forward(self, x):
        return self._map(x, "forward")

    def _inverse(self, y):
        return self._map(y, "inverse")

    def _forward_log_det_jacobian(self, x):
        return self._map(x, "forward_log_det_jacobian")
