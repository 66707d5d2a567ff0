"""Prompt-length bucketing (``next_bucket`` of
``paddle_tpu/jit/bucketing.py``). The engine pads each prompt to the
smallest bucket holding it, as the JAX engine does; eager PyTorch needs
no bucketing to bound compiles, but keeping it keeps the prefill shapes
(and so the flash kernel's launch shapes) the same as the JAX engine's.
"""
from __future__ import annotations

__all__ = ["next_bucket"]


def next_bucket(size, buckets):
    """Smallest bucket holding ``size`` (buckets ascending)."""
    for b in buckets:
        if size <= b:
            return b
    raise ValueError(
        f"size {size} exceeds the largest bucket {buckets[-1]}; add a "
        "bigger bucket"
    )
