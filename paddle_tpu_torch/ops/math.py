"""Elementwise math ops (counterpart of ``paddle_tpu/ops/impl/math.py``)
and the complex accessors ``real``, ``imag``, ``conj`` and ``angle``.

Each op keeps the JAX op's formula and defaults where PyTorch's own call
differs: ``remainder`` follows the divisor's sign, ``lerp`` is ``x + w (y
- x)``, ``logit`` clips by ``eps`` before the log, ``round(decimals=)``
scales by 10^decimals, ``outer`` flattens its inputs, ``clip`` takes None
bounds, ``scale`` has ``bias_after_scale``. The special functions are
``torch.special``'s (``lgamma``/``gammaln``, ``digamma``, ``polygamma``,
``erfinv``, ``gammaincc``, ``i0``, ``i0e``, ``i1``, ``i1e``).
"""
from __future__ import annotations

import torch

from .activation import sigmoid, tanh

__all__ = [
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil",
    "cos", "cosh", "digamma", "erf", "erfinv", "exp", "expm1", "floor",
    "lgamma", "log", "log10", "log1p", "log2", "logit", "neg",
    "reciprocal", "round", "rsqrt", "sign", "sin", "sinh", "sqrt",
    "square", "tan", "tanh", "sigmoid", "trunc", "frac", "angle", "conj",
    "real", "imag", "i0", "i0e", "i1", "i1e", "polygamma", "sinc",
    "deg2rad", "rad2deg", "nan_to_num", "add", "subtract", "multiply",
    "divide", "floor_divide", "remainder", "fmod", "pow", "maximum",
    "minimum", "fmax", "fmin", "atan2", "logaddexp", "heaviside",
    "nextafter", "copysign", "hypot", "gcd", "lcm", "ldexp", "inner",
    "outer", "scale", "clip", "lerp", "stanh", "multiplex", "addmm",
    "logaddexp2", "trapezoid", "diff", "signbit", "gammaln", "gammaincc",
    "increment", "fill", "fill_diagonal", "clip_by_norm",
    "squared_l2_norm", "renorm", "frobenius_norm", "is_empty",
]
# ``rsub`` and ``square_sum`` are helpers the JAX ops table does not export


def _t(v, like):
    """``v`` as a tensor for a binary op with ``like``: a Python number
    becomes a 0-d CPU tensor (an operand of a kernel on any device, no
    copy), of ``like``'s dtype where both are floats, as a weakly typed
    JAX scalar takes its partner's; anything else goes to ``like``'s
    device."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, int, float)):
        same = isinstance(v, float) == like.is_floating_point()
        return torch.tensor(v, dtype=like.dtype if same else None)
    return torch.as_tensor(v, device=like.device)


# -- unary -----------------------------------------------------------------
def abs(x):
    return torch.abs(x)


def acos(x):
    return torch.acos(x)


def acosh(x):
    return torch.acosh(x)


def asin(x):
    return torch.asin(x)


def asinh(x):
    return torch.asinh(x)


def atan(x):
    return torch.atan(x)


def atanh(x):
    return torch.atanh(x)


def ceil(x):
    return torch.ceil(x)


def cos(x):
    return torch.cos(x)


def cosh(x):
    return torch.cosh(x)


def digamma(x):
    return torch.special.digamma(x)


def erf(x):
    return torch.special.erf(x)


def erfinv(x):
    return torch.special.erfinv(x)


def exp(x):
    return torch.exp(x)


def expm1(x):
    return torch.expm1(x)


def floor(x):
    return torch.floor(x)


def lgamma(x):
    return torch.special.gammaln(x)


def log(x):
    return torch.log(x)


def log10(x):
    return torch.log10(x)


def log1p(x):
    return torch.log1p(x)


def log2(x):
    return torch.log2(x)


def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def neg(x):
    return torch.neg(x)


def reciprocal(x):
    return 1.0 / x


def round(x, decimals=0):
    if decimals:
        f = 10.0 ** decimals
        return torch.round(x * f) / f
    return torch.round(x)


def rsqrt(x):
    return torch.rsqrt(x)


def sign(x):
    return torch.sgn(x)


def sin(x):
    return torch.sin(x)


def sinh(x):
    return torch.sinh(x)


def sqrt(x):
    return torch.sqrt(x)


def square(x):
    return torch.square(x)


def tan(x):
    return torch.tan(x)


def trunc(x):
    return torch.trunc(x)


def frac(x):
    return x - torch.trunc(x)


def angle(x):
    return torch.angle(x)


def conj(x):
    """The conjugate, materialized (no lazy conjugate bit); a real
    tensor is returned as is."""
    return torch.conj_physical(x) if x.is_complex() else x


def real(x):
    return torch.real(x)


def imag(x):
    """The imaginary part; zeros for a real tensor, as in JAX."""
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def i0(x):
    return torch.special.i0(x)


def i0e(x):
    return torch.special.i0e(x)


def i1(x):
    return torch.special.i1(x)


def i1e(x):
    return torch.special.i1e(x)


def polygamma(x, n=1):
    return torch.special.polygamma(n, x)


def sinc(x):
    return torch.special.sinc(x)


def deg2rad(x):
    return torch.deg2rad(x)


def rad2deg(x):
    return torch.rad2deg(x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# -- binary ----------------------------------------------------------------
def add(x, y):
    return torch.add(x, y)


def subtract(x, y):
    return torch.subtract(x, y)


def multiply(x, y):
    return torch.multiply(x, y)


def divide(x, y):
    return torch.true_divide(x, y)


def floor_divide(x, y):
    return torch.div(x, y, rounding_mode="floor")


def remainder(x, y):
    # the sign follows the divisor (Python's %)
    return torch.remainder(x, y)


def fmod(x, y):
    return torch.fmod(x, y)


def pow(x, y):
    return torch.pow(x, y)


def maximum(x, y):
    return torch.maximum(x, _t(y, x))


def minimum(x, y):
    return torch.minimum(x, _t(y, x))


def fmax(x, y):
    return torch.fmax(x, _t(y, x))


def fmin(x, y):
    return torch.fmin(x, _t(y, x))


def atan2(x, y):
    return torch.atan2(x, _t(y, x))


def logaddexp(x, y):
    return torch.logaddexp(x, _t(y, x))


def heaviside(x, y):
    """0 where x < 0, ``y`` where x == 0, 1 where x > 0."""
    return torch.heaviside(x, _t(y, x).to(x.dtype))


def nextafter(x, y):
    return torch.nextafter(x, _t(y, x).to(x.dtype))


def copysign(x, y):
    return torch.copysign(x, y)


def hypot(x, y):
    return torch.hypot(x, _t(y, x))


def gcd(x, y):
    return torch.gcd(x, _t(y, x))


def lcm(x, y):
    return torch.lcm(x, _t(y, x))


def ldexp(x, y):
    return torch.ldexp(x, _t(y, x))


def inner(x, y):
    return torch.inner(x, y)


def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


# -- scalar-parameterized --------------------------------------------------
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if isinstance(scale, torch.Tensor):
        scale = scale.item()
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def clip(x, min=None, max=None):
    if isinstance(min, torch.Tensor):
        min = min.item()
    if isinstance(max, torch.Tensor):
        max = max.item()
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def lerp(x, y, weight):
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


def multiplex(inputs, index):
    """Row i of the result is row i of ``inputs[index[i]]``."""
    stacked = torch.stack(list(inputs), 0)          # [n, batch, ...]
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


def logaddexp2(x, y):
    return torch.logaddexp2(x, _t(y, x))


def rsub(x, y):
    return torch.subtract(y, x)


def square_sum(x):
    return torch.sum(torch.square(x))


def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


def signbit(x):
    return torch.signbit(x)


def gammaln(x):
    return torch.special.gammaln(x)


def gammaincc(x, y):
    """The regularized upper incomplete gamma Q(x, y)."""
    return torch.special.gammaincc(x, _t(y, x))


def increment(x, value=1.0):
    return x + torch.tensor(value, dtype=x.dtype)


def fill(x, value=0.0):
    return torch.full_like(x, value)


def fill_diagonal(x, value=0.0, offset=0, wrap=False):
    n, m = x.shape[-2], x.shape[-1]
    i = torch.arange(n, device=x.device)[:, None]
    j = torch.arange(m, device=x.device)[None, :]
    mask = j - i == offset
    if wrap and x.dim() == 2 and n > m:
        # the diagonal restarts every m + 1 rows of a tall matrix
        mask = (j - i % (m + 1)) == offset
    return torch.where(mask, torch.tensor(value, dtype=x.dtype), x)


def clip_by_norm(x, max_norm):
    xf = x.float()
    norm = torch.sqrt(torch.sum(torch.square(xf)))
    s = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return (xf * s).to(x.dtype)


def squared_l2_norm(x):
    return torch.sum(torch.square(x.float())).reshape(())


def renorm(x, p=2.0, axis=0, max_norm=1.0):
    """Each slice along ``axis`` scaled down to p-norm ``max_norm``."""
    red = tuple(d for d in range(x.dim()) if d != axis % x.dim())
    xf = x.float()
    norms = torch.sum(torch.abs(xf) ** p, dim=red, keepdim=True) ** (1.0 / p)
    s = torch.where(norms > max_norm,
                    max_norm / torch.clamp(norms, min=1e-12),
                    torch.ones_like(norms))
    return (xf * s).to(x.dtype)


def frobenius_norm(x, axis=None, keepdim=False):
    if axis is None:
        axis = (-2, -1)
    return torch.sqrt(torch.sum(torch.square(x.float()), dim=tuple(axis),
                                keepdim=keepdim)).to(x.dtype)


def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)

