"""Normalisation and attention ops of the Llama path.

Counterpart of the parts of ``paddle_tpu/ops/impl/nn_ops.py`` the
serving and training slices run: ``rms_norm``,
``scaled_dot_product_attention`` and ``cross_entropy``. Layouts follow
the JAX package: attention tensors are [batch, seq, heads, head_dim].
Each is one op of the ``amp.auto_cast`` policy, by its name
(``amp_op``).
"""
from __future__ import annotations

import math

import torch

from ..amp.auto_cast import amp_op
from ..kernels import flash_attention as _flash

__all__ = [
    "rms_norm", "scaled_dot_product_attention", "flash_eligible",
    "cross_entropy",
]


@amp_op("rms_norm")
def rms_norm(x, weight=None, *, epsilon=1e-6):
    """Over the last dim: f32 accumulation, cast back to x's dtype, then
    the scale."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def flash_eligible(query, key, value, attn_mask, is_causal):
    """The flash kernel's contract: CUDA tensors of one supported dtype
    (float32, bfloat16 or float16, as the JAX kernel takes any float),
    no mask, a supported head dim, k/v heads dividing q
    heads, and no causal call with sq != sk (the kernel's causal mask is
    top-left aligned, the math form's bottom-right; KV-cache attention
    takes the math form). When autograd will need the gradient of q, k
    or v, the head dim must also be one the backward kernels take
    (``BWD_HEAD_DIMS``); other head dims take the math form. The TPU
    version also gates on a minimum sequence length
    (``FLAGS_flash_attention_min_seq``) measured on a TPU; on the card
    every eligible call runs the kernel."""
    if query.device.type != "cuda":
        return False
    if attn_mask is not None:
        return False
    b, sq, h, d = query.shape
    if key.shape != value.shape or key.shape[3] != d or h % key.shape[2]:
        return False
    if is_causal and sq != key.shape[1]:
        return False
    if d not in _flash.SUPPORTED_HEAD_DIMS:
        return False
    if torch.is_grad_enabled() and d not in _flash.BWD_HEAD_DIMS and any(
            t.requires_grad for t in (query, key, value)):
        return False
    return (query.dtype in (torch.float32, torch.bfloat16, torch.float16)
            and key.dtype == query.dtype and value.dtype == query.dtype)


@amp_op("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None, *,
                                 is_causal=False, scale=None):
    """[batch, seq, heads, head_dim] attention. Calls that fit
    ``flash_eligible`` run the flash kernels through
    ``FlashAttentionFunction`` (forward kernel, and the backward kernels
    for the gradients of q, k and v); all others take the math
    form: f32 scores, a bottom-right aligned causal mask when
    ``is_causal`` (query i of sq sees keys j <= i + sk - sq), a bool
    keep-mask or an additive float mask, softmax, output cast back to
    the query's dtype. Key/value heads may divide the query heads (GQA):
    the math form repeats them. Attention dropout (a training option of
    the JAX version) is not ported."""
    if flash_eligible(query, key, value, attn_mask, is_causal):
        return _flash.flash_attention(
            query, key, value, causal=is_causal, scale=scale
        )
    h = query.shape[2]
    if key.shape[2] != h:
        key = key.repeat_interleave(h // key.shape[2], dim=2)
        value = value.repeat_interleave(h // value.shape[2], dim=2)
    q = query.transpose(1, 2).float()   # [b, h, s, d]
    k = key.transpose(1, 2).float()
    v = value.transpose(1, 2).float()
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    if is_causal:
        ql, kl = scores.shape[-2], scores.shape[-1]
        causal = torch.ones(
            ql, kl, dtype=torch.bool, device=scores.device
        ).tril(diagonal=kl - ql)
        scores = scores.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, float("-inf"))
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2).to(query.dtype)


@amp_op("cross_entropy")
def cross_entropy(logits, labels, ignore_index=-100, reduction="mean"):
    """Softmax cross entropy over the last dim with integer ``labels``
    (the JAX ``cross_entropy`` with hard labels): f32 log-softmax, the
    label's log-probability picked, rows whose label is ``ignore_index``
    contribute 0. ``reduction="mean"`` divides by the number of valid
    rows (at least 1); ``"sum"`` and ``"none"`` as named. Soft labels,
    class weights and label smoothing are not ported."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).float()
    if reduction == "sum":
        return loss.sum()
    return loss
