"""Activations of the Llama path (counterpart of
``paddle_tpu/ops/impl/activation.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from ..amp.auto_cast import amp_op

__all__ = ["swiglu"]


@amp_op("swiglu")
def swiglu(x, y):
    """silu(x) * y, the Llama MLP gate."""
    return F.silu(x) * y
