"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``).

Each initializer is a callable ``(shape, dtype="float32", generator=None)
-> torch.Tensor`` (on the CPU). The random ones draw from ``generator``;
``Layer.create_parameter`` passes the generator of the innermost
``init_generator`` block, or None, which is torch's default CPU
generator (``torch.manual_seed``). The JAX package draws from its global
PRNG key instead, so the same seed gives other values here: weights are
carried across with ``set_state_dict`` or ``load_reference_state``.
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "NormalInitializer",
    "ConstantInitializer", "UniformInitializer", "MSRA",
    "set_global_initializer", "calculate_gain", "param_init_override",
    "init_generator",
]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype).removeprefix("paddle.")]


class _Generators(threading.local):
    def __init__(self):
        self.stack = []


_generators = _Generators()


@contextlib.contextmanager
def init_generator(generator):
    """Every parameter created in the block (on this thread) draws from
    ``generator``, a CPU ``torch.Generator``; the entry points'
    ``seed=`` arguments use it."""
    _generators.stack.append(generator)
    try:
        yield generator
    finally:
        _generators.stack.pop()


def current_generator():
    """The innermost ``init_generator``'s generator, or None."""
    return _generators.stack[-1] if _generators.stack else None


class Initializer:
    def __call__(self, shape, dtype="float32", generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype))


def _normal(shape, generator):
    return torch.randn(tuple(shape), generator=generator)


def _uniform(shape, low, high, generator):
    return torch.empty(tuple(shape)).uniform_(low, high, generator=generator)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", generator=None):
        return (self.mean + self.std * _normal(shape, generator)).to(
            _dtype(dtype))


class TruncatedNormal(Initializer):
    """``mean + std * z``, z normal truncated to [a, b] (in units of the
    standard deviation, as the JAX initializer)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32", generator=None):
        z = torch.nn.init.trunc_normal_(torch.empty(tuple(shape)), 0.0, 1.0,
                                        self.a, self.b, generator=generator)
        return (self.mean + self.std * z).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", generator=None):
        return _uniform(shape, self.low, self.high, generator).to(
            _dtype(dtype))


def _fans(shape):
    """(fan_in, fan_out): a matrix is [in, out]; a conv kernel [out, in,
    *spatial]."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", generator=None):
        fin, fout = _fans(shape)
        std = self.gain * math.sqrt(
            2.0 / ((self._fan_in or fin) + (self._fan_out or fout)))
        return (std * _normal(shape, generator)).to(_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", generator=None):
        fin, fout = _fans(shape)
        limit = self.gain * math.sqrt(
            6.0 / ((self._fan_in or fin) + (self._fan_out or fout)))
        return _uniform(shape, -limit, limit, generator).to(_dtype(dtype))


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return math.sqrt(2.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", generator=None):
        fin = self._fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) / \
            math.sqrt(fin)
        return (std * _normal(shape, generator)).to(_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", generator=None):
        fin = self._fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) * \
            math.sqrt(3.0 / fin)
        return _uniform(shape, -limit, limit, generator).to(_dtype(dtype))


class Assign(Initializer):
    """The given values (a tensor, an array or a list), reshaped to the
    parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None):
        v = self.value
        t = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        t = t.to(_dtype(dtype))
        return t.reshape(tuple(shape)) if shape else t


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", generator=None):
        t = torch.nn.init.orthogonal_(torch.empty(tuple(shape)), self.gain,
                                      generator=generator)
        return t.to(_dtype(dtype))


class Dirac(Initializer):
    """1 at the centre of kernel (i, i % in) for i < min(out, in *
    groups), 0 elsewhere."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", generator=None):
        out = torch.zeros(tuple(shape))
        oc, ic = shape[0], shape[1]
        centre = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centre] = 1.0
        return out.to(_dtype(dtype))


# the JAX package's historical aliases
NormalInitializer = Normal
ConstantInitializer = Constant
UniformInitializer = Uniform
MSRA = KaimingNormal

_global_initializer = {"weight": XavierNormal(), "bias": Constant(0.0)}
# the strongest precedence: create_parameter consults this first
_init_override = {"initializer": None, "dtype": None}


class param_init_override:
    """Every ``create_parameter`` inside the block uses this initializer
    and/or dtype, over the layers' defaults and their ParamAttr."""

    def __init__(self, initializer=None, dtype=None):
        self._init = initializer
        self._dtype = dtype

    def __enter__(self):
        self._saved = dict(_init_override)
        if self._init is not None:
            _init_override["initializer"] = self._init
        if self._dtype is not None:
            _init_override["dtype"] = self._dtype
        return self

    def __exit__(self, *exc):
        _init_override.update(self._saved)
        return False


def set_global_initializer(weight_init, bias_init=None):
    _global_initializer["weight"] = weight_init
    if bias_init is not None:
        _global_initializer["bias"] = bias_init


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains[nonlinearity]
