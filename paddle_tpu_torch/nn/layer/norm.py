"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
``BatchNorm``, ``BatchNorm1D/2D/3D``, ``SyncBatchNorm``, ``LayerNorm``,
``RMSNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
``LocalResponseNorm`` and ``SpectralNorm``.

The batch norms keep their running statistics as f32 buffers named
``_mean`` and ``_variance``, the JAX names, so a JAX state dict and a
checkpoint map onto them one to one. In training they normalise by the
batch's statistics and update the running ones as the JAX layer does:
``running = momentum * running + (1 - momentum) * batch`` with the
batch's biased variance (``ops.batch_norm_with_stats``), in place and
outside autograd. A 16-bit input's statistics are computed in f32 and
the buffers stay f32 under ``amp``.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ... import ops as F
from ...ops import nn_ops
from .. import initializer as I
from ..parameter import ParamAttr
from .layers import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
    "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
    "LocalResponseNorm", "SpectralNorm",
]


def _param(layer, name, shape, attr, value, is_bias=False, dtype=None):
    """``layer.<name>``: a parameter of ``shape`` starting at ``value``
    (unless ``attr`` names an initializer), or None for ``attr=False``."""
    if attr is False:
        layer.add_parameter(name, None)
        return
    attr = ParamAttr._to_attr(attr)
    if attr.initializer is None:
        attr.initializer = I.Constant(value)
    setattr(layer, name, layer.create_parameter(
        shape=shape, attr=attr, is_bias=is_bias, dtype=dtype))


class _BatchNormBase(Layer):
    _expected_ndim = None

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _param(self, "weight", [num_features], weight_attr, 1.0,
               dtype="float32")
        _param(self, "bias", [num_features], bias_attr, 0.0, is_bias=True,
               dtype="float32")
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        if self._expected_ndim is not None and x.dim() != self._expected_ndim:
            raise ValueError(
                f"expected {self._expected_ndim}D input, got {x.dim()}D")
        use_global = (self._use_global_stats
                      if self._use_global_stats is not None
                      else not self.training)
        if use_global:
            return F.batch_norm(
                x, self._mean, self._variance, self.weight, self.bias,
                False, self._momentum, self._epsilon, self._data_format,
                True)
        out, mean, var = nn_ops._batch_norm_train(
            x, self.weight, self.bias, epsilon=self._epsilon,
            c_axis=nn_ops._channel_axis(x, self._data_format))
        with torch.no_grad():
            self._mean.lerp_(mean.to(self._mean.dtype), 1.0 - self._momentum)
            self._variance.lerp_(var.to(self._variance.dtype),
                                 1.0 - self._momentum)
        return out

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """Any rank, channel axis 1 (or last for a channel-last format)."""


class BatchNorm1D(_BatchNormBase):
    def forward(self, x):
        if x.dim() == 2:
            return super().forward(x.unsqueeze(-1)).squeeze(-1)
        if x.dim() != 3:
            raise ValueError(
                f"BatchNorm1D expects 2D/3D input, got {x.dim()}D")
        return super().forward(x)


class BatchNorm2D(_BatchNormBase):
    _expected_ndim = 4


class BatchNorm3D(_BatchNormBase):
    _expected_ndim = 5


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm. On one process (the only form the port
    runs; the collectives are ROADMAP A9) it is ``BatchNorm``'s math."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            if layer.weight is not None:
                out.weight = layer.weight
            if layer.bias is not None:
                out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in layer.named_children():
            new_sub = cls.convert_sync_batchnorm(sub)
            if new_sub is not sub:
                setattr(out, name, new_sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, numbers.Integral):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _param(self, "weight", self._normalized_shape, weight_attr, 1.0)
        _param(self, "bias", self._normalized_shape, bias_attr, 0.0,
               is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias,
                            self._normalized_shape, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(Layer):
    """The Llama-family norm; f32 accumulation inside ``ops.rms_norm``.
    No bias unless ``bias_attr`` asks for one."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 bias_attr=False, name=None):
        super().__init__()
        if isinstance(normalized_shape, numbers.Integral):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _param(self, "weight", self._normalized_shape, weight_attr, 1.0)
        _param(self, "bias", self._normalized_shape,
               False if bias_attr is None else bias_attr, 0.0, is_bias=True)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.bias, epsilon=self._epsilon,
                          begin_norm_axis=-len(self._normalized_shape))

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        if num_channels % num_groups != 0:
            raise ValueError("num_channels must be divisible by num_groups")
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        _param(self, "weight", [num_channels], weight_attr, 1.0,
               dtype="float32")
        _param(self, "bias", [num_channels], bias_attr, 0.0, is_bias=True,
               dtype="float32")

    def forward(self, x):
        return F.group_norm(x, self.weight, self.bias, self._num_groups,
                            self._epsilon, self._data_format)

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}")


class _InstanceNormBase(Layer):
    _expected_ndim = None

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_features = num_features
        self._epsilon = epsilon
        self._data_format = data_format
        _param(self, "scale", [num_features], weight_attr, 1.0)
        _param(self, "bias", [num_features], bias_attr, 0.0, is_bias=True)

    def forward(self, x):
        if self._expected_ndim is not None and x.dim() != self._expected_ndim:
            raise ValueError(
                f"expected {self._expected_ndim}D input, got {x.dim()}D")
        return F.instance_norm(x, self.scale, self.bias, self._epsilon,
                               self._data_format)

    def extra_repr(self):
        return f"num_features={self._num_features}, epsilon={self._epsilon}"


class InstanceNorm1D(_InstanceNormBase):
    _expected_ndim = 3


class InstanceNorm2D(_InstanceNormBase):
    _expected_ndim = 4


class InstanceNorm3D(_InstanceNormBase):
    _expected_ndim = 5


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self._data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self._data_format)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma its largest singular value along ``dim``
    by ``power_iters`` steps of power iteration from the buffers
    ``weight_u`` and ``weight_v`` (drawn as the JAX layer draws them,
    from numpy's RandomState(0)). The iteration runs outside autograd and
    updates the buffers; sigma = u^T W v is differentiated through W."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        rng = np.random.RandomState(0)
        u = rng.normal(0, 1, h).astype(np.float32)
        v = rng.normal(0, 1, w).astype(np.float32)
        self.register_buffer("weight_u", torch.from_numpy(u))
        self.register_buffer("weight_v", torch.from_numpy(v))

    def forward(self, weight):
        w = weight.movedim(self._dim, 0) if self._dim != 0 else weight
        mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            m = mat.detach()
            u, v = self.weight_u, self.weight_v
            for _ in range(self._power_iters):
                v = m.t() @ u
                v = v / (v.norm() + self._epsilon)
                u = m @ v
                u = u / (u.norm() + self._epsilon)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = (u.reshape(1, -1) @ mat @ v.reshape(-1, 1)).reshape(())
        return weight / sigma
