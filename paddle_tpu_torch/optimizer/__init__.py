"""Optimizers and learning-rate schedulers of the port."""
from . import lr
from .adam import Adam
from .adamw import AdamW
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "lr"]
