"""Fault injection (counterpart of ``paddle_tpu.resilience``, cut to the
``faults`` registry the serving front door and the journal fire)."""
from . import faults
from .faults import FaultInjector, FaultSpec

__all__ = ["faults", "FaultSpec", "FaultInjector"]
