"""Fault injection and retry (counterpart of ``paddle_tpu.resilience``, cut
to the ``faults`` registry the serving stack fires and the
``RetryPolicy`` the fleet's replica supervisor restarts under)."""
from . import faults
from .faults import FaultInjector, FaultSpec
from .retry import RetryPolicy, retry_call

__all__ = ["faults", "FaultSpec", "FaultInjector", "RetryPolicy",
           "retry_call"]
