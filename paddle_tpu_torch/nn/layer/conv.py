"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``).
Weights are [out, in / groups, *k] for a convolution and [in, out /
groups, *k] for a transposed one, on both sides, and start as the JAX
layers' do: ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))`` for the
weight and the bias, fan_in = in / groups * prod(k)."""
from __future__ import annotations

import numpy as np

from ... import ops as F
from .. import initializer as I
from ..parameter import ParamAttr
from .layers import Layer

__all__ = [
    "Conv1D", "Conv2D", "Conv3D",
    "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
]


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return [int(v)] * n
    v = list(v)
    return v * n if len(v) == 1 else v


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, transposed,
                 dims, stride=1, padding=0, output_padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if out_channels % groups != 0:
            raise ValueError("out_channels must be divisible by groups")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, dims)
        self._stride = _ntuple(stride, dims)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _ntuple(dilation, dims)
        self._groups = groups
        self._data_format = data_format
        self._dims = dims
        self._transposed = transposed
        if transposed:
            shape = [in_channels, out_channels // groups] + self._kernel_size
        else:
            shape = [out_channels, in_channels // groups] + self._kernel_size
        bound = 1.0 / np.sqrt(
            in_channels // groups * int(np.prod(self._kernel_size)))
        attr = ParamAttr._to_attr(weight_attr)
        if attr.initializer is None:
            attr.initializer = I.Uniform(-bound, bound)
        self.weight = self.create_parameter(shape=shape, attr=attr)
        if bias_attr is False:
            self.add_parameter("bias", None)
        else:
            battr = ParamAttr._to_attr(bias_attr)
            if battr.initializer is None:
                battr.initializer = I.Uniform(-bound, bound)
            self.bias = self.create_parameter(
                shape=[out_channels], attr=battr, is_bias=True)

    def extra_repr(self):
        s = (f"{self._in_channels}, {self._out_channels}, "
             f"kernel_size={self._kernel_size}, stride={self._stride}")
        if self._groups != 1:
            s += f", groups={self._groups}"
        return s + f", data_format={self._data_format}"


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, False, 1,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, False, 2,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, False, 3,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, True, 1,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, True, 2,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, True, 3,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            self._data_format)
