"""Activation recomputation (gradient checkpointing).

Counterpart of ``paddle_tpu/distributed/recompute.py``: the segment's
activations are dropped after the forward and recomputed in the
backward, trading operations for device memory. Here it is
``torch.utils.checkpoint`` in its non-reentrant form, which gives the
gradients of the segment's parameters as well as of its tensor inputs
and replays a custom ``autograd.Function`` (the flash kernels) inside the
segment. ``recompute_sequential`` is not ported.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward instead of saved."""
    return checkpoint(function, *args, use_reentrant=False, **kwargs)
