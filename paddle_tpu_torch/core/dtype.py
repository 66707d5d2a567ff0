"""Dtype names (counterpart of ``to_jnp`` in ``paddle_tpu/core/dtype.py``):
a name the JAX package takes, or a ``torch.dtype``, as a ``torch.dtype``."""
import torch

_BY_NAME = {"float16": torch.float16, "bfloat16": torch.bfloat16,
            "float32": torch.float32, "float64": torch.float64,
            "int32": torch.int32, "int64": torch.int64}


def to_torch(dtype, default=None):
    """``dtype`` (a name such as "float32", or a ``torch.dtype``) as a
    ``torch.dtype``; None gives ``default``."""
    if dtype is None:
        return default
    return _BY_NAME[dtype] if isinstance(dtype, str) else dtype
