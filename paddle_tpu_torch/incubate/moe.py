"""Mixture-of-Experts layer.

Counterpart of ``paddle_tpu/incubate/moe.py``: ``TopKGate`` (softmax
top-k router; its ``forward`` is the dense GShard one-hot contract that a
custom gate keeps), ``SwiGLUExperts`` (stacked expert FFNs, one grouped
product per projection) and ``MoELayer`` with two paths:

* ``impl="dense"``: sort-based routing into a capacity-padded
  ``[e, c, m]`` buffer (``ops.moe_gate_dispatch``), the expert FFN as
  batched einsums, ``ops.moe_combine``. Tokens past an expert's capacity
  are dropped, as in the JAX package.
* ``impl="ragged"``: dropless sort-by-expert dispatch and one
  ``grouped_matmul`` per projection over contiguous expert segments (the
  hand-written CUDA kernel on the card); ``capacity_factor`` is ignored.
  Int8 experts (``quantization.quantize_moe_experts``) run only here.

Parameter layout and names are the JAX package's: gate ``weight
[d_model, e]``, ``w_gate``/``w_up [e, d_model, d_ff]``, ``w_down [e,
d_ff, d_model]``, and the ``*_scale`` buffers ``None`` until quantized.
The layer is built on the CUDA device unless ``device`` names another
one; its weights are drawn Xavier-uniform (the JAX package's fans) from
a ``torch.Generator`` seeded with ``seed``. Expert parallelism (the JAX
``ep`` mesh axis) is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.activation import swiglu
from ..ops.moe_ops import (
    grouped_matmul,
    moe_combine,
    moe_gate_dispatch,
    moe_ragged_combine,
    moe_ragged_dispatch,
)

__all__ = ["TopKGate", "MoELayer", "SwiGLUExperts"]


def _fans(shape):
    """(fan_in, fan_out) as the JAX package's initializers count them:
    [in, out] for 2-D, [d0, d1, *rest] -> (d1 * rest, d0 * rest)."""
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def _xavier_uniform_(w, generator=None):
    """Xavier-uniform in f32 from ``generator`` (a fresh one seeded 0 on
    ``w``'s device when None), cast to ``w``'s dtype."""
    if generator is None:
        generator = torch.Generator(device=w.device).manual_seed(0)
    fan_in, fan_out = _fans(tuple(w.shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    noise = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    noise.uniform_(-limit, limit, generator=generator)
    w.copy_(noise)


class TopKGate(nn.Module):
    """Softmax top-k router, ``weight [d_model, num_experts]``.
    ``forward(x [s, m])`` returns the dense GShard contract (dispatch
    [s, e, c], combine [s, e, c], aux_loss); ``MoELayer`` routes a stock
    ``TopKGate`` through the sort-based ops instead."""

    def __init__(self, d_model, num_experts, k=2, capacity_factor=1.25,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.weight = nn.Parameter(torch.empty(
            d_model, num_experts, device=resolve_device(device), dtype=dtype))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        _xavier_uniform_(self.weight, generator)

    def capacity(self, num_tokens):
        return int(np.ceil(self.k * num_tokens / self.num_experts
                           * self.capacity_factor))

    def forward(self, x):
        s = x.shape[0]
        e = self.num_experts
        c = self.capacity(s)
        gates = torch.softmax(x @ self.weight, dim=-1)
        remaining = gates
        dispatch = combine = occupancy = top1 = None
        for _ in range(self.k):
            idx = torch.argmax(remaining, dim=-1)
            onehot = nn.functional.one_hot(idx, e).to(gates.dtype)
            if top1 is None:
                top1 = onehot
            # position of each token in its expert's buffer
            pos = torch.cumsum(onehot, 0) - onehot
            if occupancy is not None:
                pos = pos + occupancy
            occupancy = onehot.sum(0, keepdim=True) + (
                occupancy if occupancy is not None else 0.0)
            in_cap = (pos < float(c)).to(gates.dtype) * onehot
            posc = (pos * onehot).sum(-1).to(torch.int64)
            pos_onehot = nn.functional.one_hot(
                torch.clamp(posc, max=c - 1), c).to(gates.dtype)
            part = in_cap[:, :, None] * pos_onehot[:, None, :]   # [s, e, c]
            gate_k = (gates * onehot).sum(-1, keepdim=True)
            cpart = part * gate_k[..., None]
            dispatch = part if dispatch is None else dispatch + part
            combine = cpart if combine is None else combine + cpart
            remaining = remaining * (1.0 - onehot)
        # renormalize over the selected experts (Mixtral convention)
        combine = combine / (combine.sum((1, 2), keepdim=True) + 1e-9)
        me = gates.mean(0)
        ce = top1.mean(0)
        aux = (me * ce).sum() * float(e)
        return dispatch, combine, aux


class SwiGLUExperts(nn.Module):
    """Stacked expert FFNs: ``w_gate``/``w_up [e, d_model, d_ff]``,
    ``w_down [e, d_ff, d_model]``. After ``quantize_moe_experts`` the
    three weights are int8 with f32 ``*_scale [e, out]`` buffers and run
    only through ``forward_ragged``."""

    def __init__(self, num_experts, d_model, d_ff, device=None, dtype=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)

        def mk(shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))

        self.w_gate = mk((num_experts, d_model, d_ff))
        self.w_up = mk((num_experts, d_model, d_ff))
        self.w_down = mk((num_experts, d_ff, d_model))
        self.register_buffer("w_gate_scale", None)
        self.register_buffer("w_up_scale", None)
        self.register_buffer("w_down_scale", None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        for w in (self.w_gate, self.w_up, self.w_down):
            _xavier_uniform_(w, generator)

    @property
    def quantized(self):
        return self.w_gate_scale is not None

    def forward(self, dispatched):
        """dispatched [e, c, m] -> [e, c, m]."""
        if self.quantized:
            raise RuntimeError(
                "int8-quantized experts only run through the ragged "
                'path: use MoELayer(impl="ragged")'
            )
        g = torch.einsum("ecm,emf->ecf", dispatched, self.w_gate)
        u = torch.einsum("ecm,emf->ecf", dispatched, self.w_up)
        return torch.einsum("ecf,efm->ecm", swiglu(g, u), self.w_down)

    def forward_ragged(self, x_sorted, group_sizes):
        """x_sorted [n, m] expert-sorted rows, group_sizes [e] -> [n, m]:
        one ``grouped_matmul`` per projection (int8 experts dequantize in
        the kernel through their per-channel scales)."""
        g = grouped_matmul(x_sorted, self.w_gate, group_sizes,
                           self.w_gate_scale)
        u = grouped_matmul(x_sorted, self.w_up, group_sizes,
                           self.w_up_scale)
        return grouped_matmul(swiglu(g, u), self.w_down, group_sizes,
                              self.w_down_scale)


class MoELayer(nn.Module):
    """forward: [b, s, m] -> ([b, s, m], aux_loss), with
    ``return_stats=True`` a third dict of drop counters."""

    def __init__(self, d_model, num_experts, d_ff=None, k=2,
                 capacity_factor=1.25, gate=None, experts=None,
                 impl="dense", device=None, dtype=None, seed=0):
        super().__init__()
        if impl not in ("dense", "ragged"):
            raise ValueError(
                f'MoELayer impl must be "dense" or "ragged", got {impl!r}'
            )
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        self.d_model = d_model
        self.num_experts = num_experts
        self.gate = gate if gate is not None else TopKGate(
            d_model, num_experts, k, capacity_factor, device, dtype,
            generator)
        self.experts = experts if experts is not None else SwiGLUExperts(
            num_experts, d_model, d_ff or 4 * d_model, device, dtype,
            generator)
        if impl == "ragged":
            if gate is not None and type(gate) is not TopKGate:
                raise ValueError(
                    'MoELayer(impl="ragged") needs the stock TopKGate '
                    "routing (custom gates keep the dense dispatch/"
                    "combine contract)"
                )
            if not hasattr(self.experts, "forward_ragged"):
                raise ValueError(
                    'MoELayer(impl="ragged") needs experts exposing '
                    "forward_ragged(x_sorted, group_sizes)"
                )
        self.impl = impl

    def forward(self, x, return_stats=False):
        """A stock ``TopKGate`` routes through the sort-based ops; a custom
        ``gate`` (a ``TopKGate`` subclass included) keeps the dense
        contract: its forward gives (dispatch, combine, aux)."""
        b, s, m = x.shape
        flat = x.reshape(b * s, m)
        if type(self.gate) is not TopKGate:
            dispatch, combine, aux = self.gate(flat)
            dispatched = torch.einsum("sec,sm->ecm", dispatch, flat)
            expert_out = self.experts(dispatched)
            out = torch.einsum("sec,ecm->sm", combine, expert_out)
            out = out.reshape(b, s, m)
            return (out, aux, {}) if return_stats else (out, aux)
        logits = flat @ self.gate.weight
        if self.impl == "ragged":
            xs, group_sizes, order, cw, _, aux = moe_ragged_dispatch(
                flat, logits, k=self.gate.k)
            ys = self.experts.forward_ragged(xs, group_sizes)
            out = moe_ragged_combine(ys, order, cw).reshape(b, s, m)
            stats = {"dropped_assignments": 0,
                     "total_assignments": b * s * self.gate.k,
                     "capacity": None}
            return (out, aux, stats) if return_stats else (out, aux)
        cap = self.gate.capacity(b * s)
        dispatched, cw, eids, slots, aux, n_drop = moe_gate_dispatch(
            flat, logits, k=self.gate.k, capacity=cap)
        expert_out = self.experts(dispatched)
        out = moe_combine(expert_out, cw, eids, slots).reshape(b, s, m)
        stats = {"dropped_assignments": n_drop,
                 "total_assignments": b * s * self.gate.k,
                 "capacity": cap}
        return (out, aux, stats) if return_stats else (out, aux)
