"""Learning-rate schedulers.

The port's copy of ``paddle_tpu/optimizer/lr.py``: the ``LRScheduler``
base and its 17 schedulers, each with ``state_dict``/``set_state_dict``.
Host-side Python, the same value at every step as the JAX package: the
optimizer reads ``scheduler()`` once per step and the caller advances it
with ``scheduler.step()``.
"""
from __future__ import annotations

import math

__all__ = [
    "LRScheduler",
    "NoamDecay",
    "PiecewiseDecay",
    "NaturalExpDecay",
    "InverseTimeDecay",
    "PolynomialDecay",
    "LinearWarmup",
    "ExponentialDecay",
    "MultiStepDecay",
    "StepDecay",
    "LambdaDecay",
    "MultiplicativeDecay",
    "ReduceOnPlateau",
    "CosineAnnealingDecay",
    "CosineAnnealingWarmRestarts",
    "CyclicLR",
    "OneCycleLR",
    "LinearLR",
]


class LRScheduler:
    """Base class.

    Subclasses implement ``get_lr()`` reading ``self.last_epoch`` /
    ``self.base_lr``. ``step()`` advances the epoch counter and refreshes
    ``self.last_lr``.
    """

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
            print(
                f"Epoch {self.last_epoch}: {type(self).__name__} set "
                f"learning rate to {self.last_lr}."
            )

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        state = {}
        for k, v in self.__dict__.items():
            if k == "verbose" or callable(v):
                continue
            if isinstance(v, (int, float, bool, str, list, tuple, dict, type(None))):
                state[k] = v
        return state

    def set_state_dict(self, state_dict):
        for k, v in state_dict.items():
            if k in self.__dict__:
                self.__dict__[k] = v
        return self

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    """Step-function schedule over boundaries."""

    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        if len(values) != len(boundaries) + 1:
            raise ValueError(
                "values must have one more element than boundaries"
            )
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[-1]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * max(div, 1)
        else:
            step = min(step, decay_steps)
        frac = (1 - step / float(decay_steps)) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    """Linear ramp into a wrapped scheduler or constant lr."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        if not isinstance(learning_rate, (float, int, LRScheduler)):
            raise TypeError("learning_rate must be float or LRScheduler")
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (
            learning_rate
            if isinstance(learning_rate, (float, int))
            else learning_rate.base_lr
        )
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
        state_dict = dict(state_dict)   # the caller's dict stays whole
        inner = state_dict.pop("LinearWarmup_LR", None)
        if inner is not None and isinstance(self.learning_rate, LRScheduler):
            self.learning_rate.set_state_dict(inner)
        return super().set_state_dict(state_dict)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        if not all(
            milestones[i] < milestones[i + 1]
            for i in range(len(milestones) - 1)
        ):
            raise ValueError("milestones must be increasing")
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        passed = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** passed)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (
            self.gamma ** (max(self.last_epoch, 0) // self.step_size)
        )


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        state = super().state_dict()
        state.pop("lr_lambda", None)
        return state


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def step(self, epoch=None):
        # O(1) incremental path only once last_lr provably corresponds to
        # last_epoch (i.e. after one full get_lr); a construction-time
        # last_epoch jump or explicit epoch uses the full product.
        if epoch is None and getattr(self, "_incremental_ok", False):
            self.last_epoch += 1
            if self.last_epoch > 0:
                self.last_lr = self.last_lr * self.lr_lambda(self.last_epoch)
            if self.verbose:
                print(
                    f"Epoch {self.last_epoch}: MultiplicativeDecay set "
                    f"learning rate to {self.last_lr}."
                )
            return
        super().step(epoch)
        self._incremental_ok = True

    def get_lr(self):
        cur = self.base_lr
        for epoch in range(1, self.last_epoch + 1):
            cur *= self.lr_lambda(epoch)
        return cur

    def state_dict(self):
        state = super().state_dict()
        state.pop("lr_lambda", None)
        return state


class ReduceOnPlateau(LRScheduler):
    """Reduce lr when a metric has stopped improving. ``step(metrics)`` takes the watched value."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError("threshold_mode must be 'rel' or 'abs'")
        if factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.cooldown_counter = 0
        self.best = None
        self.num_bad_epochs = 0
        # no super().step() in init: plateau stepping is metric-driven
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def step(self, metrics, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        # a python number, a numpy scalar or a one-element torch tensor
        metrics = float(metrics)

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            if self.best is None or self._is_better(metrics):
                self.best = metrics
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
                new_lr = max(self.last_lr * self.factor, self.min_lr)
                if self.last_lr - new_lr > self.epsilon:
                    self.last_lr = new_lr
                    if self.verbose:
                        print(
                            f"Epoch {self.last_epoch}: ReduceOnPlateau set "
                            f"learning rate to {self.last_lr}."
                        )

    def _is_better(self, current):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best - self.best * self.threshold
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best + self.best * self.threshold
        return current > self.best + self.threshold

    def get_lr(self):
        return self.last_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self.last_epoch / self.T_max))
            / 2
        )


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        if T_0 <= 0 or not isinstance(T_0, int):
            raise ValueError("T_0 must be a positive integer")
        if T_mult < 1 or not isinstance(T_mult, int):
            raise ValueError("T_mult must be an integer >= 1")
        self.T_0 = T_0
        self.T_i = T_0
        self.T_mult = T_mult
        self.eta_min = float(eta_min)
        self.T_cur = last_epoch
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self.T_cur / self.T_i))
            / 2
        )

    def step(self, epoch=None):
        if epoch is None:
            epoch = self.last_epoch + 1
            self.T_cur += 1
            if self.T_cur >= self.T_i:
                self.T_cur -= self.T_i
                self.T_i *= self.T_mult
        else:
            if epoch >= self.T_0:
                if self.T_mult == 1:
                    self.T_cur = epoch % self.T_0
                    self.T_i = self.T_0
                else:
                    n = int(
                        math.log(
                            epoch / self.T_0 * (self.T_mult - 1) + 1,
                            self.T_mult,
                        )
                    )
                    self.T_cur = epoch - self.T_0 * (
                        self.T_mult ** n - 1
                    ) / (self.T_mult - 1)
                    self.T_i = self.T_0 * self.T_mult ** n
            else:
                self.T_i = self.T_0
                self.T_cur = epoch
        self.last_epoch = epoch
        self.last_lr = self.get_lr()


class CyclicLR(LRScheduler):
    """Triangular cyclic schedule."""

    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.step_size_up = step_size_up
        self.step_size_down = (
            step_size_down if step_size_down is not None else step_size_up
        )
        self.total_size = self.step_size_up + self.step_size_down
        self.mode = mode
        self.exp_gamma = exp_gamma
        self._custom_scale_fn = scale_fn
        self.scale_mode = scale_mode if scale_fn else {
            "triangular": "cycle",
            "triangular2": "cycle",
            "exp_range": "iterations",
        }.get(mode, "cycle")
        super().__init__(base_learning_rate, last_epoch, verbose)

    def _scale(self, x):
        if self._custom_scale_fn is not None:
            return self._custom_scale_fn(x)
        if self.mode == "triangular":
            return 1.0
        if self.mode == "triangular2":
            return 1 / (2.0 ** (x - 1))
        return self.exp_gamma ** x

    def get_lr(self):
        iterations = self.last_epoch
        cycle = 1 + iterations // self.total_size
        pct_per_step = (iterations % self.total_size) / self.total_size
        pct_up = self.step_size_up / self.total_size
        if pct_per_step <= pct_up:
            scale_factor = pct_per_step / pct_up
        else:
            scale_factor = (1 - pct_per_step) / (1 - pct_up)
        base_height = (self.max_lr - self.base_lr) * scale_factor
        x = cycle if self.scale_mode == "cycle" else iterations
        return self.base_lr + base_height * self._scale(x)

    def state_dict(self):
        state = super().state_dict()
        state.pop("_custom_scale_fn", None)
        return state


class OneCycleLR(LRScheduler):
    """1cycle policy, cosine annealing strategy."""

    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.anneal_strategy = anneal_strategy
        if three_phase:
            self._phases = [
                (float(phase_pct * total_steps) - 1, initial_lr,
                 max_learning_rate),
                (float(2 * phase_pct * total_steps) - 2, max_learning_rate,
                 initial_lr),
                (total_steps - 1, initial_lr, end_learning_rate),
            ]
        else:
            self._phases = [
                (float(phase_pct * total_steps) - 1, initial_lr,
                 max_learning_rate),
                (total_steps - 1, max_learning_rate, end_learning_rate),
            ]
        super().__init__(initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal_strategy == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = self.last_epoch
        start_step = 0.0
        for end_step, start_lr, end_lr in self._phases:
            if step <= end_step or end_step == self._phases[-1][0]:
                pct = (step - start_step) / (end_step - start_step)
                return self._anneal(start_lr, end_lr, min(max(pct, 0.0), 1.0))
            start_step = end_step
        return self.end_lr

    def state_dict(self):
        state = super().state_dict()
        state.pop("_phases", None)
        return state


class LinearLR(LRScheduler):
    """Linearly ramp the multiplier from start_factor to end_factor over
    total_steps."""

    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        if start_factor > 1.0 or start_factor <= 0:
            raise ValueError("start_factor must be in (0, 1]")
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        pct = min(max(self.last_epoch, 0), self.total_steps) / self.total_steps
        factor = self.start_factor + (self.end_factor - self.start_factor) * pct
        return self.base_lr * factor
