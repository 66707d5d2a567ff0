"""Activation layers (counterpart of
``paddle_tpu/nn/layer/activation.py``): thin layers over the port's
activation ops. ``PReLU`` is the one with a parameter; ``RReLU`` takes a
``generator=`` for its training-time slopes."""
from __future__ import annotations

from ... import ops as F
from .. import initializer as I
from ..parameter import ParamAttr
from .layers import Layer

__all__ = [
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "RReLU", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "ThresholdedReLU",
]


class _Simple(Layer):
    """Base of the stateless activations; ``_extra`` names the attributes
    ``extra_repr`` shows."""

    _extra = ()

    def extra_repr(self):
        return ", ".join(f"{k}={getattr(self, k)}" for k in self._extra)


class ReLU(_Simple):
    def forward(self, x):
        return F.relu(x)


class ReLU6(_Simple):
    def forward(self, x):
        return F.relu6(x)


class ELU(_Simple):
    _extra = ("alpha",)

    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class CELU(_Simple):
    _extra = ("alpha",)

    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class GELU(_Simple):
    _extra = ("approximate",)

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class GLU(_Simple):
    _extra = ("axis",)

    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class Hardshrink(_Simple):
    _extra = ("threshold",)

    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Hardsigmoid(_Simple):
    def forward(self, x):
        return F.hardsigmoid(x)


class Hardswish(_Simple):
    def forward(self, x):
        return F.hardswish(x)


class Hardtanh(_Simple):
    _extra = ("min", "max")

    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min = min
        self.max = max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class LeakyReLU(_Simple):
    _extra = ("negative_slope",)

    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class LogSigmoid(_Simple):
    def forward(self, x):
        return F.log_sigmoid(x)


class LogSoftmax(_Simple):
    _extra = ("axis",)

    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Maxout(_Simple):
    _extra = ("groups", "axis")

    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class Mish(_Simple):
    def forward(self, x):
        return F.mish(x)


class PReLU(Layer):
    """Learnable negative slope: one, or one per channel (axis 1)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._num_parameters = num_parameters
        self._data_format = data_format
        attr = ParamAttr._to_attr(weight_attr)
        if attr.initializer is None:
            attr.initializer = I.Constant(init)
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=attr
        )

    def forward(self, x):
        return F.prelu(x, self.weight)

    def extra_repr(self):
        return f"num_parameters={self._num_parameters}"


class RReLU(_Simple):
    _extra = ("lower", "upper")

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *,
                 generator=None):
        super().__init__()
        self.lower = lower
        self.upper = upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training,
                       generator=self.generator)


class SELU(_Simple):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale = scale
        self.alpha = alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class Sigmoid(_Simple):
    def forward(self, x):
        return F.sigmoid(x)


class Silu(_Simple):
    def forward(self, x):
        return F.silu(x)


class Softmax(_Simple):
    _extra = ("axis",)

    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class Softplus(_Simple):
    _extra = ("beta", "threshold")

    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta = beta
        self.threshold = threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Softshrink(_Simple):
    _extra = ("threshold",)

    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softsign(_Simple):
    def forward(self, x):
        return F.softsign(x)


class Swish(_Simple):
    def forward(self, x):
        return F.swish(x)


class Tanh(_Simple):
    def forward(self, x):
        return F.tanh(x)


class Tanhshrink(_Simple):
    def forward(self, x):
        return F.tanhshrink(x)


class ThresholdedReLU(_Simple):
    _extra = ("threshold",)

    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold = threshold
        self.value = value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)
