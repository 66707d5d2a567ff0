"""Activations (counterpart of ``paddle_tpu/ops/impl/activation.py``):
``swiglu`` of the Llama path and the activations of the ``nn`` layer
set, each with the JAX op's formula and defaults (``hardsigmoid``'s slope
0.1666667, ``rrelu``'s bounds). The random ones (``rrelu`` in training,
``gumbel_softmax``) draw from ``generator``, standing in for the JAX
package's PRNG key."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp.auto_cast import amp_op

__all__ = [
    "swiglu", "relu", "relu_", "relu6", "leaky_relu", "prelu", "elu",
    "selu", "celu", "gelu", "silu", "swish", "mish", "softplus",
    "softsign", "softshrink", "hardshrink", "tanhshrink", "hardtanh",
    "hardsigmoid", "hardswish", "log_sigmoid", "sigmoid", "tanh", "tanh_",
    "softmax", "log_softmax", "gumbel_softmax", "glu", "maxout",
    "thresholded_relu", "rrelu",
]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


@amp_op("swiglu")
def swiglu(x, y=None):
    """silu(x) * y, the Llama MLP gate; with ``y`` None, x's two halves
    along the last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


@amp_op("relu")
def relu(x):
    return F.relu(x)


def relu_(x):
    """In place."""
    return x.relu_()


@amp_op("relu6")
def relu6(x):
    return F.relu6(x)


@amp_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


@amp_op("prelu")
def prelu(x, weight):
    """``x`` where x >= 0, else ``weight * x``; a weight of more than one
    element runs along axis 1 (the channels)."""
    w = weight
    if w.numel() > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@amp_op("elu")
def elu(x, alpha=1.0):
    return F.elu(x, alpha)


@amp_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("celu")
def celu(x, alpha=1.0):
    return F.celu(x, alpha)


@amp_op("gelu")
def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


@amp_op("silu")
def silu(x):
    return F.silu(x)


@amp_op("swish")
def swish(x):
    return F.silu(x)


@amp_op("mish")
def mish(x):
    return F.mish(x)


@amp_op("softplus")
def softplus(x, beta=1.0, threshold=20.0):
    """``x`` where ``beta * x > threshold``, else log1p(exp(beta x)) /
    beta."""
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.log1p(torch.exp(scaled)) / beta)


@amp_op("softsign")
def softsign(x):
    return F.softsign(x)


@amp_op("softshrink")
def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


@amp_op("hardshrink")
def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@amp_op("tanhshrink")
def tanhshrink(x):
    return x - torch.tanh(x)


@amp_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0):
    return x.clamp(min, max)


@amp_op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return (slope * x + offset).clamp(0.0, 1.0)


@amp_op("hardswish")
def hardswish(x):
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


@amp_op("log_sigmoid")
def log_sigmoid(x):
    return F.logsigmoid(x)


@amp_op("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@amp_op("tanh")
def tanh(x):
    return torch.tanh(x)


def tanh_(x):
    """In place."""
    return x.tanh_()


def _as_dtype(x, dtype):
    if dtype is None:
        return x
    return x.to(_DTYPES.get(str(dtype), dtype))


@amp_op("softmax")
def softmax(x, axis=-1, dtype=None):
    return torch.softmax(_as_dtype(x, dtype), dim=int(axis))


@amp_op("log_softmax")
def log_softmax(x, axis=-1, dtype=None):
    return torch.log_softmax(_as_dtype(x, dtype), dim=int(axis))


@amp_op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, *,
                   generator=None):
    """softmax((x + Gumbel noise) / temperature); with ``hard``, the
    one-hot of its argmax forward and the soft gradient backward."""
    u = torch.rand(x.shape, device=x.device, generator=generator)
    tiny = torch.finfo(torch.float32).tiny
    # g = -log(-log(u)), jax.random.gumbel's draw; -log(u) > 0 is clamped
    # away from 0 (u near 1) and u away from 0, so g stays finite
    e = -torch.log(u.clamp(tiny, 1.0))
    g = (-torch.log(e.clamp_min(tiny))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


@amp_op("glu")
def glu(x, axis=-1):
    """First half times the sigmoid of the second half along ``axis``."""
    return F.glu(x, dim=int(axis))


@amp_op("maxout")
def maxout(x, groups, axis=1):
    """Max over each run of ``groups`` consecutive channels of ``axis``
    (channel c of the output takes channels c * groups .. c * groups +
    groups - 1)."""
    axis = int(axis) % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(dim=axis + 1)


@amp_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@amp_op("rrelu")
def rrelu(x, lower=0.125, upper=0.3333333, training=True, *,
          generator=None):
    """Leaky ReLU whose negative slope is drawn from U(lower, upper) per
    element in training, their mean otherwise."""
    if training:
        a = torch.rand(x.shape, device=x.device, generator=generator).to(
            x.dtype) * (upper - lower) + lower
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)
