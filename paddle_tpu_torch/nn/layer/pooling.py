"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``).
``exclusive=True`` (the default) leaves the padding out of an average
(torch's ``count_include_pad=False``). ``ceil_mode`` is honoured (the
JAX pools ignore it; ``ops.max_pool2d``)."""
from __future__ import annotations

from ... import ops as F
from .layers import Layer

__all__ = [
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D",
]


class _PoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.data_format = data_format

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format="NCL")
        if return_mask:
            raise NotImplementedError(
                "return_mask is only implemented for MaxPool2D")

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format)


class MaxPool2D(_PoolNd):
    """With ``return_mask``, (out, mask): the flat H * W index of each
    window's maximum (``ops.max_pool2d_with_index``)."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format=data_format)
        self.return_mask = return_mask

    def forward(self, x):
        if self.return_mask:
            return F.max_pool2d_with_index(
                x, self.kernel_size, self.stride, self.padding,
                self.ceil_mode, self.data_format)
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format)


class MaxPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format=data_format)
        if return_mask:
            raise NotImplementedError(
                "return_mask is only implemented for MaxPool2D")

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format)


class AvgPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         data_format="NCL")

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, not self.exclusive,
                            self.data_format)


class AvgPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, not self.exclusive,
                            self.data_format)


class AvgPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         data_format=data_format)

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, not self.exclusive,
                            self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self._output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)

    def extra_repr(self):
        return f"output_size={self._output_size}"


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        if return_mask:
            raise NotImplementedError(
                "AdaptiveMaxPool2D return_mask is not implemented")
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._output_size)

    def extra_repr(self):
        return f"output_size={self._output_size}"
