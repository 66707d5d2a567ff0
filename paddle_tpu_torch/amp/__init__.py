"""Automatic mixed precision (counterpart of ``paddle_tpu.amp``): the
``auto_cast`` policy by op name, ``decorate`` and the ``GradScaler``."""
from .auto_cast import (
    amp_guard,
    auto_cast,
    black_list,
    decorate,
    get_amp_dtype,
    is_auto_cast_enabled,
    white_list,
)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "is_auto_cast_enabled",
           "get_amp_dtype", "white_list", "black_list", "GradScaler",
           "AmpScaler"]
