"""Training utilities of the port."""
from .clip import (
    ClipGradBase,
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
)

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue"]
