"""Distributed training helpers of the port (one card so far)."""
from .recompute import recompute

__all__ = ["recompute"]
