"""Optimizer base class.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: parameter groups, a
float or ``LRScheduler`` learning rate, gradient clipping, a coupled L2
weight decay, fp32 master weights for bf16/f16 parameters
(``multi_precision``) and an accumulator ``state_dict``. The update math
is the JAX ``_make_step_fn``'s, in the same order: clip the gradients,
cast each to the dtype of the weight it updates (the master where there
is one), add the coupled decay, apply the decoupled decay to that weight,
then the subclass's rule, then round the master back into the parameter.

The JAX package stages the whole update into one XLA program. Here it
runs eagerly, in place, with ``torch._foreach_*`` ops over all parameters
at once (one launch per op for a list of tensors, not one per tensor).
``torch.optim`` is not used: it keeps no master weights. Not ported:
L1Decay/L2Decay objects (a float weight decay is L2), per-parameter
regularizers, the GradScaler hook, ZeRO shardings and the chunked and
donated update.

Parameters are named as in the JAX package, ``param_0``, ``param_1``, ...
in the order given, unless they come as ``(name, parameter)`` pairs
(``model.named_parameters()``), which keep their names. The names key
``state_dict`` and are what ``apply_decay_param_fun`` sees.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ..nn.clip import ClipGradByGlobalNorm
from .lr import LRScheduler

__all__ = ["Optimizer"]


class _Attr(NamedTuple):
    """Per-parameter attributes of one update."""

    lr_scale: float
    l2_coeff: float
    need_clip: bool
    multi_precision: bool
    decoupled_decay: float = 0.0   # AdamW: w *= 1 - lr * coeff
    lr_ratio: float = 1.0          # AdamW: lr_ratio(param)


def _l2_coeff(weight_decay):
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    raise TypeError(
        f"weight_decay must be a float (L2) or None, got {weight_decay!r}"
    )


class Optimizer:
    """Subclasses define

    * ``_init_state(w) -> dict[slot, tensor]`` for a weight ``w`` (the
      master when there is one);
    * ``_update(weights, grads, states, lrs, t)``, which updates the
      weights and states in place; ``lrs`` are the per-parameter
      effective learning rates and ``t`` the 1-based global step.
    """

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError(
                "parameters is required (pass model.parameters() or "
                "model.named_parameters())"
            )
        parameters = list(parameters)
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradByGlobalNorm):
            raise TypeError("grad_clip must be a ClipGradByGlobalNorm")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be float or LRScheduler")
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._default_weight_decay = weight_decay
        self._param_groups = []
        self._names = {}          # id(param) -> name
        self._accumulators = {}   # id(param) -> {slot: tensor}
        self._global_step = 0
        if parameters and isinstance(parameters[0], dict):
            for group in parameters:
                self._add_param_group(dict(group))
        else:
            self._add_param_group(
                {"params": parameters, "weight_decay": weight_decay}
            )

    # -- parameter groups -------------------------------------------------
    def _add_param_group(self, group):
        params = group["params"]
        if isinstance(params, torch.Tensor):
            params = [params]
        named = []
        for p in params:
            if isinstance(p, tuple):
                name, p = p
            else:
                name = f"param_{len(self._names)}"
            self._names.setdefault(id(p), name)
            named.append(p)
        group["params"] = named
        group.setdefault("weight_decay", self._default_weight_decay)
        group.setdefault("learning_rate", 1.0)
        self._param_groups.append(group)

    @property
    def _parameter_list(self):
        return [p for g in self._param_groups for p in g["params"]]

    def param_name(self, p):
        return self._names[id(p)]

    # -- learning rate ----------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is an LRScheduler; "
                "call scheduler.step() instead"
            )
        self._learning_rate = float(value)

    # -- state ------------------------------------------------------------
    def _init_state(self, w):
        return {}

    def _use_master(self, p):
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _ensure_state(self, p):
        st = self._accumulators.get(id(p))
        if st is None:
            if self._use_master(p):
                master = p.detach().float().clone()
                st = self._init_state(master)
                st["master_weight"] = master
            else:
                st = self._init_state(p.detach())
            self._accumulators[id(p)] = st
        return st

    def _param_extras(self, p, group):
        """(decoupled decay coefficient, lr ratio) of ``p``: AdamW's."""
        return 0.0, 1.0

    def _group_l2(self, group):
        return _l2_coeff(group.get("weight_decay"))

    def _collect(self):
        """(param, grad, attr) for every parameter that requires grad and
        has one."""
        out = []
        for group in self._param_groups:
            l2 = self._group_l2(group)
            lr_scale = float(group.get("learning_rate", 1.0))
            for p in group["params"]:
                if not p.requires_grad or p.grad is None:
                    continue
                decay, ratio = self._param_extras(p, group)
                out.append((p, p.grad, _Attr(
                    lr_scale=lr_scale, l2_coeff=l2,
                    need_clip=getattr(p, "need_clip", True),
                    multi_precision=self._use_master(p),
                    decoupled_decay=decay, lr_ratio=ratio,
                )))
        return out

    # -- the update -------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad``. With ``grad_clip``
        the gradients are clipped in place (as
        ``torch.nn.utils.clip_grad_norm_`` does)."""
        triples = self._collect()
        if triples:
            if self._grad_clip is not None:
                self._grad_clip.clip_([g for _, g, _ in triples],
                                      [a.need_clip for _, _, a in triples])
            lr = self.get_lr()
            weights, grads, states, lrs = [], [], [], []
            for p, g, a in triples:
                st = self._ensure_state(p)
                w = st["master_weight"] if a.multi_precision else p.data
                g = g.to(w.dtype)
                if a.l2_coeff:
                    g = g + a.l2_coeff * w
                eff_lr = lr * a.lr_scale * a.lr_ratio
                if a.decoupled_decay:
                    w.mul_(1.0 - eff_lr * a.decoupled_decay)
                weights.append(w)
                grads.append(g)
                states.append(st)
                lrs.append(eff_lr)
            self._update(weights, grads, states, lrs, self._global_step + 1)
            for p, _, a in triples:
                if a.multi_precision:
                    p.copy_(self._accumulators[id(p)]["master_weight"])
        self._global_step += 1

    def _update(self, weights, grads, states, lrs, t):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    # -- checkpointing ----------------------------------------------------
    def state_dict(self):
        """Accumulators keyed ``{name}_{slot}_0``, ``global_step`` and the
        scheduler's state under ``LR_Scheduler``."""
        out = collections.OrderedDict()
        for p in self._parameter_list:
            for slot, t in (self._accumulators.get(id(p)) or {}).items():
                out[f"{self._names[id(p)]}_{slot}_0"] = t.detach().clone()
        out["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        if "global_step" in state_dict:
            self._global_step = int(state_dict["global_step"])
        for p in self._parameter_list:
            st = self._ensure_state(p)
            for slot in list(st):
                key = f"{self._names[id(p)]}_{slot}_0"
                if key not in state_dict:
                    continue
                src = torch.as_tensor(state_dict[key])
                if tuple(src.shape) != tuple(st[slot].shape):
                    raise ValueError(
                        f"shape mismatch for optimizer state {key}: "
                        f"{tuple(src.shape)} vs {tuple(st[slot].shape)}"
                    )
                st[slot].copy_(src)
        return self
