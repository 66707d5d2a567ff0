"""Fault injection, retry and bit-exact training resume (counterpart of
``paddle_tpu.resilience``): the ``faults`` registry the serving and
training stacks fire, the ``RetryPolicy`` the fleet's replica supervisor
restarts under, and ``train_state`` — ``TrainState`` capture/restore,
the preemption exit-code protocol and the hang-safe ``TrainLoop``."""
from . import faults, train_state
from .faults import FaultInjector, FaultSpec
from .retry import RetryPolicy, retry_call
from .train_state import (
    HANG_EXIT_CODE,
    PREEMPT_EXIT_CODE,
    PreemptionHandler,
    TrainLoop,
    TrainState,
    preemption_requested,
    request_preemption,
)

__all__ = [
    "faults", "FaultSpec", "FaultInjector", "RetryPolicy", "retry_call",
    "train_state", "TrainState", "TrainLoop", "PreemptionHandler",
    "request_preemption", "preemption_requested", "PREEMPT_EXIT_CODE",
    "HANG_EXIT_CODE",
]
