"""High-level API (counterpart of ``paddle_tpu.hapi``): ``Model`` and its
callbacks."""
from .callbacks import Callback, EarlyStopping, LRScheduler, ProgBarLogger
from .model import Model

__all__ = ["Model", "Callback", "ProgBarLogger", "EarlyStopping",
           "LRScheduler"]
