"""Learning-rate schedulers.

Counterpart of ``paddle_tpu/optimizer/lr.py`` for the schedulers the
pretraining slice uses: the ``LRScheduler`` base, ``LinearWarmup`` and
``CosineAnnealingDecay``. Host-side Python, the same value at every step
as the JAX package: the optimizer reads ``scheduler()`` once per step and
the caller advances it with ``scheduler.step()``. The other schedulers
of the JAX package are not ported yet.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "LinearWarmup", "CosineAnnealingDecay"]


class LRScheduler:
    """Subclasses implement ``get_lr()`` from ``self.last_epoch`` and
    ``self.base_lr``; ``step()`` advances the epoch and refreshes
    ``self.last_lr``."""

    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        if not isinstance(learning_rate, (int, float)):
            raise TypeError(
                f"learning_rate must be float, got {type(learning_rate)}"
            )
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: {type(self).__name__} set "
                  f"learning rate to {self.last_lr}.")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {
            k: v for k, v in self.__dict__.items()
            if k != "verbose" and not callable(v) and isinstance(
                v, (int, float, bool, str, list, tuple, dict, type(None)))
        }

    def set_state_dict(self, state_dict):
        for k, v in state_dict.items():
            if k in self.__dict__:
                self.__dict__[k] = v
        return self


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then a wrapped scheduler (stepped with the epochs after the warm-up)
    or a constant learning rate."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        if not isinstance(learning_rate, (float, int, LRScheduler)):
            raise TypeError("learning_rate must be float or LRScheduler")
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (learning_rate if isinstance(learning_rate, (float, int))
                else learning_rate.base_lr)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / float(self.warmup_steps)
            ) + self.start_lr
        if isinstance(self.learning_rate, LRScheduler):
            self.learning_rate.step(self.last_epoch - self.warmup_steps)
            return self.learning_rate()
        return float(self.learning_rate)

    def state_dict(self):
        state = super().state_dict()
        state.pop("learning_rate", None)
        if isinstance(self.learning_rate, LRScheduler):
            state["LinearWarmup_LR"] = self.learning_rate.state_dict()
        return state

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        inner = state_dict.pop("LinearWarmup_LR", None)
        if inner is not None and isinstance(self.learning_rate, LRScheduler):
            self.learning_rate.set_state_dict(inner)
        return super().set_state_dict(state_dict)


class CosineAnnealingDecay(LRScheduler):
    """eta_min + (base_lr - eta_min) (1 + cos(pi epoch / T_max)) / 2."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)
        ) / 2
