"""Loss scaling.

Counterpart of ``paddle_tpu/amp/grad_scaler.py``: ``GradScaler`` (alias
``AmpScaler``) with the JAX package's dynamic-scaling state machine.
``scale(loss)`` multiplies the loss by the scale; ``unscale_``
divides every gradient by it in place and keeps one device-side
all-finite flag over all of them, read once per step (one host sync, not
one per parameter); ``step`` skips the optimizer's update when a
gradient held an inf or a NaN; ``update`` halves the scale after
``decr_every_n_nan_or_inf`` bad steps and doubles it after
``incr_every_n_steps`` good ones. ``state_dict`` round-trips the scale
and its step counters.

The scaler's arithmetic runs outside any ``auto_cast`` policy (the JAX
package runs it outside its dispatch hook): a scaled float32 loss stays
float32.
"""
from __future__ import annotations

import torch

from .auto_cast import suspended

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        with suspended():
            return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        if self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()"
            )
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        with suspended():
            if grads:
                # one device-side flag over every gradient (before the
                # division, as the JAX scaler reads it), one host read
                all_finite = torch.stack(
                    [torch.isfinite(g).all() for g in grads]).all()
                torch._foreach_mul_(grads, 1.0 / self._scale)
                self._found_inf = not bool(all_finite)
            else:
                self._found_inf = False
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_scale_ratio(self):
        return self._scale

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
