"""Training utilities of the port."""
from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm"]
