"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Linear``, ``Bilinear``, ``Embedding``, the dropouts, ``Flatten``,
``Identity``, the pads, the upsampling layers, ``PixelShuffle``,
``PixelUnshuffle``, ``Unfold`` and ``CosineSimilarity``.

``Linear`` keeps the JAX layer's [in, out] weight and computes ``x @ W +
b``, so its state dict (and a checkpoint) is the JAX one's. It is not a
``torch.nn.Linear`` (whose weight is [out, in]): ``load_reference_state``
transposes only those. The dropouts take a ``generator=`` for their
masks (the device's default generator when None).
"""
from __future__ import annotations

from ... import ops as F
from .. import initializer as I
from .layers import Layer

__all__ = [
    "Linear", "Bilinear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Identity", "Upsample",
    "UpsamplingNearest2D", "UpsamplingBilinear2D", "PixelShuffle",
    "PixelUnshuffle", "Unfold", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "CosineSimilarity",
]


class Linear(Layer):
    """Weight [in_features, out_features] (``XavierNormal``), bias zeros."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        if bias_attr is not False:
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True)
        else:
            self.add_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode, self.axis,
                         generator=self.generator)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = [0, 1] if data_format == "NCHW" else [0, 3]
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, "upscale_in_train",
                         self.axis, generator=self.generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = [0, 1] if data_format == "NCDHW" else [0, 4]
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, "upscale_in_train",
                         self.axis, generator=self.generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training,
                               generator=self.generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.data_format)


UpsamplingNearest2D = Upsample


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "bilinear",
                             True, self.data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    pass


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    pass


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """Weight [out, in1, in2] (``XavierNormal``), bias [1, out]."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        if bias_attr is not False:
            self.bias = self.create_parameter([1, out_features],
                                              attr=bias_attr, is_bias=True)
        else:
            self.add_parameter("bias", None)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)
