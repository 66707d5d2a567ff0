"""Prompt-length bucketing (``next_bucket`` of
``paddle_tpu/jit/bucketing.py``). The engine pads each prompt to the
smallest bucket holding it, as the JAX engine does: one prefill program
(a CUDA graph on the card) per bucket bounds the programs built, as the
buckets bound the JAX engine's compiles.
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
