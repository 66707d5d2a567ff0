"""Fused ops of the Llama path.

Counterparts in ``paddle_tpu/ops/impl/fused_ops.py``:

* ``rope_qk`` and the parts of ``fused_rotary_position_embedding`` it
  uses: rotation angles built from the base, per-row ``position_ids``,
  neox (rotate-halves) style, f32 math cast back to the input dtype. q/k
  are [batch, seq, heads, head_dim]. The GPT-J (interleaved) style is not
  ported: Llama does not use it. Its two halves, ``rope_table`` (the
  angles, JAX's ``_build_rope_cache``) and ``apply_rope`` (JAX's
  ``_apply_rope``), serve the serving adapter, which builds the table
  once per program and rotates inside ``kernels.rope_kv_write``.
* ``fused_linear_cross_entropy``: the chunked LM head plus loss.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import amp_op
__all__ = ["rope_qk", "rope_table", "apply_rope",
           "fused_linear_cross_entropy"]


def rope_table(positions, head_dim, base=10000.0):
    """The rotation angles' ``(cos, sin)``, f32 ``[*positions.shape,
    head_dim / 2]``, for integer or float ``positions``. The serving
    adapter builds it once per program call for the rows it writes;
    ``rope_qk`` builds it per call."""
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=positions.device) / head_dim)
    )
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin):
    """Rotate ``x`` [..., heads, head_dim] neox style by ``cos``/``sin``
    [..., head_dim / 2] (one row per row of x, shared by its heads): f32
    math, cast back to x's dtype."""
    xf = x.float()
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


@amp_op("rope_qk")
def rope_qk(q, k, position_ids=None, *, base=10000.0):
    """Rotate q and k. ``position_ids`` ([b, s] or [s]) gives each token's
    absolute position (decode rotates the new token at its cache
    position); None means positions 0..s-1."""
    if position_ids is None:
        position_ids = torch.arange(q.shape[1], device=q.device)[None]
    elif position_ids.dim() == 1:
        position_ids = position_ids[None, :]
    cos, sin = rope_table(position_ids.to(q.device), q.shape[-1], base)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """Mean CE of ``x @ weight.T`` over the rows whose label is not
    ``ignore_index``, ``chunk`` rows at a time. The forward keeps only
    each row's logsumexp; the backward recomputes each chunk's logits and
    forms its gradient (softmax minus one-hot) chunk by chunk, so no
    [N, vocab] tensor exists in either direction."""

    @staticmethod
    def forward(ctx, x, weight, labels, chunk, ignore_index):
        vocab = weight.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for i in range(0, x.shape[0], chunk):
            logits = (x[i:i + chunk] @ weight.t()).float()
            lse = torch.logsumexp(logits, dim=-1)
            y = labels[i:i + chunk]
            gold = logits.gather(1, y.clamp(0, vocab - 1).long()[:, None])
            total += torch.where(y != ignore_index, lse - gold[:, 0],
                                 torch.zeros_like(lse)).sum()
            lses.append(lse)
        count = (labels != ignore_index).sum().clamp(min=1).float()
        lse = torch.cat(lses) if lses else total.new_zeros(0)
        ctx.save_for_backward(x, weight, labels, lse, count)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return total / count

    @staticmethod
    def backward(ctx, grad):
        x, weight, labels, lse, count = ctx.saved_tensors
        chunk, vocab = ctx.chunk, weight.shape[0]
        dx = torch.empty_like(x)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        scale = grad.float() / count
        for i in range(0, x.shape[0], chunk):
            xc = x[i:i + chunk]
            logits = (xc @ weight.t()).float()
            d = torch.exp(logits - lse[i:i + chunk, None])
            y = labels[i:i + chunk]
            valid = (y != ctx.ignore_index).float()
            rows = torch.arange(y.shape[0], device=y.device)
            d[rows, y.clamp(0, vocab - 1).long()] -= 1.0
            d = (d * (valid * scale)[:, None]).to(x.dtype)
            dx[i:i + chunk] = d @ weight
            dw += (d.t() @ xc).float()
        return dx, dw.to(weight.dtype), None, None, None


@amp_op("fused_linear_cross_entropy")
def fused_linear_cross_entropy(x, weight, labels, *, chunk_size=4096,
                               ignore_index=-100):
    """Chunked LM head plus softmax cross entropy: the mean CE of
    ``x @ weight.T`` against ``labels`` over the rows whose label is not
    ``ignore_index``, without ever building the [N, vocab] logits.

    x: [N, d]; weight: [vocab, d] (the ``nn.Linear`` / embedding layout;
    the JAX op takes its transpose, [d, vocab]); labels: [N] int. Logits
    are computed in x's dtype and taken to f32 for the loss, as in the
    JAX op; each chunk's logits are recomputed in the backward. The JAX
    op pads the last chunk with ``ignore_index`` rows; here the last
    chunk is shorter, which gives the same mean. Labels outside
    [0, vocab) other than ``ignore_index`` are clamped, as there."""
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[1]:
        raise ValueError(
            f"fused_linear_cross_entropy: want x [N, d], weight [vocab, d],"
            f" got {tuple(x.shape)}, {tuple(weight.shape)}"
        )
    if labels.shape != (x.shape[0],):
        raise ValueError(
            f"fused_linear_cross_entropy: labels {tuple(labels.shape)} do "
            f"not match x rows {x.shape[0]}"
        )
    chunk = max(1, min(int(chunk_size), x.shape[0]))
    return _FusedLinearCrossEntropy.apply(
        x.contiguous(), weight, labels, chunk, int(ignore_index)
    )
