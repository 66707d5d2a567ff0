"""Activations of the Llama path (counterpart of
``paddle_tpu/ops/impl/activation.py``)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["swiglu"]


def swiglu(x, y):
    """silu(x) * y, the Llama MLP gate."""
    return F.silu(x) * y
