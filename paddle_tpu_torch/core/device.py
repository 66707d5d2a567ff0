"""Device selection for the port's entry points.

The port runs on the CUDA device unless the caller asks for another one.
A missing CUDA device is an error that names the device, never a quiet
move to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device=None`` -> the current CUDA device, or ``RuntimeError`` if
    there is none. Anything else is passed to ``torch.device`` as is
    (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default, but no "
            "CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
