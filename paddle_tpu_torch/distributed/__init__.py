"""Distributed training helpers of the port (one card, one process so
far): recomputation, checkpoints in the JAX package's format v2, and the
communication watchdog."""
from . import checkpoint, watchdog
from .checkpoint import (
    CheckpointCorruptError,
    load_full,
    load_state_dict,
    save_state_dict,
    wait_async_save,
)
from .recompute import recompute, recompute_sequential
from .watchdog import (
    CommTimeoutError,
    CommWatchdog,
    disable_comm_watchdog,
    enable_comm_watchdog,
    get_comm_watchdog,
)

__all__ = [
    "recompute", "recompute_sequential", "checkpoint", "watchdog",
    "save_state_dict", "load_state_dict", "load_full", "wait_async_save",
    "CheckpointCorruptError", "CommWatchdog", "CommTimeoutError",
    "enable_comm_watchdog", "disable_comm_watchdog", "get_comm_watchdog",
]
