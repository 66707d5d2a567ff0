"""Sort-based MoE dispatch and combine.

Counterpart of ``paddle_tpu/ops/impl/moe_ops.py``: top-k routing, a
sort of the (token, choice) assignments by the composite key (expert,
choice rank, token), and either a capacity-padded ``[e, c, m]`` buffer
(``moe_gate_dispatch`` / ``moe_combine``, the dense path) or the
expert-sorted rows of the dropless ragged path
(``moe_ragged_dispatch`` / ``moe_ragged_combine``, whose expert FFN is
``grouped_matmul``).

Where PyTorch differs from JAX, and what this module does about it:

* ``torch.topk`` promises no order among ties, ``jax.lax.top_k`` puts
  the lower index first: a stable descending sort does the same.
* The composite key is int64, so it never overflows and one argsort
  gives the order (the JAX two-argsort branch for int32 overflow is not
  needed; the order is the same).
* JAX drops out-of-range scatter rows (``mode="drop"``), PyTorch raises:
  dropped assignments are routed to one spare row past the buffer, which
  is cut off.
* The ragged combine gathers each token's k rows through the inverse of
  the sort permutation and sums them, where JAX scatter-adds: a float
  ``index_add_`` on CUDA uses atomics and is not deterministic.
* The aux loss is one expression (``_aux_loss``) for both paths, so the
  dense and ragged paths give bit-identical aux losses. It counts the
  top-1 fraction exactly (count / s) where JAX adds 1 / s count times.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import grouped_matmul as _gmm

__all__ = [
    "moe_gate_dispatch", "moe_combine", "moe_ragged_dispatch",
    "moe_ragged_combine", "grouped_matmul",
]


def _route(gate_logits, k):
    """(gates [s, e] f32, top-k values [s, k], top-k experts [s, k] int64),
    ties to the lower expert index as in ``jax.lax.top_k``."""
    gates = torch.softmax(gate_logits.float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return gates, vals[:, :k], idx[:, :k]


def _sort_assignments(idx, s, k):
    """(flat experts [s*k], order [s*k]): ``order`` sorts the assignments
    (token t, choice j) = flat index t*k + j by (expert, j, t): within an
    expert, every first choice before every second choice, ties by
    token."""
    flat_e = idx.reshape(-1)
    ar = torch.arange(s * k, device=idx.device)
    composite = flat_e * (s * k) + (ar % k) * s + ar // k
    return flat_e, torch.argsort(composite, stable=True)


def _aux_loss(gates, idx, e):
    """GShard load-balancing loss, e * sum(mean gate * top-1 fraction),
    the top-1 fraction counted before any capacity drop."""
    s = gates.shape[0]
    me = gates.mean(0)
    ce = F.one_hot(idx[:, 0], e).sum(0).float() / s
    return (me * ce).sum() * float(e)


def moe_gate_dispatch(x, gate_logits, *, k=2, capacity=0, renormalize=True):
    """Route tokens to experts into a capacity-padded buffer.

    x [s, m], gate_logits [s, e]. Returns (dispatched [e, c, m],
    combine_weights [s, k], expert_ids [s, k], slots [s, k] (-1 =
    dropped), aux_loss, n_dropped). An explicit capacity is honoured
    exactly; 0 means ceil(s*k/e) rounded up to a multiple of 8. Tokens
    past an expert's capacity are dropped (slot -1, weight 0), and the
    combine weights are renormalized over the kept assignments."""
    s, m = x.shape
    e = gate_logits.shape[-1]
    gates, vals, idx = _route(gate_logits, k)
    if capacity:
        c = int(capacity)
    else:
        c = -(-(s * k) // e)
        c = max(8, -(-c // 8) * 8)
    flat_e, order = _sort_assignments(idx, s, k)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device), right=False
    )
    pos_within = torch.arange(s * k, device=x.device) - seg_start[sorted_e]
    keep = pos_within < c
    tok = order // k
    # dropped rows land on the spare row e*c, cut off after the write
    dest = torch.where(keep, sorted_e * c + pos_within,
                       torch.full_like(pos_within, e * c))
    dispatched = torch.zeros((e * c + 1, m), dtype=x.dtype, device=x.device)
    dispatched = dispatched.index_put((dest,), x[tok])[:-1].reshape(e, c, m)
    slot_sorted = torch.where(keep, pos_within, torch.full_like(pos_within,
                                                                -1))
    slots = torch.empty_like(slot_sorted).index_put_((order,), slot_sorted)
    slots = slots.reshape(s, k)
    if renormalize:
        kept_w = vals * (slots >= 0).to(vals.dtype)
        vals = kept_w / (kept_w.sum(-1, keepdim=True) + 1e-9)
    aux = _aux_loss(gates, idx, e)
    n_dropped = (~keep).sum().to(torch.int32)
    return (dispatched, vals.to(x.dtype), idx.to(torch.int32),
            slots.to(torch.int32), aux, n_dropped)


def moe_combine(expert_out, combine_weights, expert_ids, slots):
    """Inverse of ``moe_gate_dispatch``: gather each assignment's expert
    output and weight it; dropped assignments (slot -1) give 0.
    expert_out [e, c, m] -> [s, m]."""
    _, _, m = expert_out.shape
    s, k = expert_ids.shape
    safe = slots.clamp_min(0).reshape(-1).long()
    rows = expert_out[expert_ids.reshape(-1).long(), safe]   # [s*k, m]
    w = (combine_weights * (slots >= 0).to(combine_weights.dtype)).reshape(
        -1, 1)
    return (rows * w.to(rows.dtype)).reshape(s, k, m).sum(1)


def moe_ragged_dispatch(x, gate_logits, *, k=2, renormalize=True):
    """Dropless sort-by-expert dispatch for the ragged grouped GEMM.

    x [s, m], gate_logits [s, e]. Returns (x_sorted [s*k, m], group_sizes
    [e] int32, order [s*k] int64 (sorted row r holds assignment
    ``order[r]``: token ``order[r] // k``, choice ``order[r] % k``),
    combine_weights [s, k], expert_ids [s, k] int32, aux_loss). The gate
    math is ``moe_gate_dispatch``'s with nothing dropped."""
    s, m = x.shape
    e = gate_logits.shape[-1]
    gates, vals, idx = _route(gate_logits, k)
    flat_e, order = _sort_assignments(idx, s, k)
    # one count per expert: a one-hot sum, not bincount, whose output
    # size depends on the data (a compiled graph keeps [e] static)
    group_sizes = F.one_hot(flat_e, e).sum(0).to(torch.int32)
    x_sorted = x[order // k]
    if renormalize:
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    aux = _aux_loss(gates, idx, e)
    return (x_sorted, group_sizes, order, vals.to(x.dtype),
            idx.to(torch.int32), aux)


def moe_ragged_combine(y_sorted, order, combine_weights):
    """Inverse of ``moe_ragged_dispatch``: weight each expert-sorted row
    by its assignment's combine weight and sum each token's k rows,
    gathered through the inverse permutation. y_sorted [s*k, m] ->
    [s, m]."""
    sk, m = y_sorted.shape
    s, k = combine_weights.shape
    order = order.long()
    w = combine_weights.reshape(-1)[order]
    weighted = y_sorted * w[:, None].to(y_sorted.dtype)
    inverse = torch.empty_like(order).index_put_(
        (order,), torch.arange(sk, device=order.device))
    return weighted[inverse].reshape(s, k, m).sum(1)


def grouped_matmul(lhs, rhs, group_sizes, rhs_scales=None):
    """Ragged grouped GEMM over contiguous expert segments, the op face
    of ``kernels.grouped_matmul`` (the CUDA kernel on the card, its plain
    version on the CPU; int8 ``rhs`` with per-channel ``rhs_scales``)."""
    return _gmm.grouped_matmul(lhs, rhs, group_sizes, rhs_scales)
