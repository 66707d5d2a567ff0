"""Normalisation, attention and loss ops of the Llama and DiT paths.

Counterpart of the parts of ``paddle_tpu/ops/impl/nn_ops.py`` the
serving and training slices run: ``rms_norm``,
``scaled_dot_product_attention`` (with attention dropout),
``cross_entropy`` in all its forms and ``softmax_with_cross_entropy``.
Layouts follow the JAX package: attention tensors are [batch, seq,
heads, head_dim]. Each is one op of the ``amp.auto_cast`` policy, by its
name (``amp_op``).
"""
from __future__ import annotations

import math

import torch

from ..amp.auto_cast import amp_op
from ..kernels import flash_attention as _flash

__all__ = [
    "rms_norm", "scaled_dot_product_attention", "flash_eligible",
    "cross_entropy", "softmax_with_cross_entropy",
]


@amp_op("rms_norm")
def rms_norm(x, weight=None, bias=None, *, epsilon=1e-6, begin_norm_axis=-1):
    """Over the dims from ``begin_norm_axis`` on (the last by default):
    f32 accumulation, cast back to x's dtype, then the scale and the
    bias."""
    ax = begin_norm_axis % x.dim()
    xf = x.float()
    var = xf.square().mean(dim=tuple(range(ax, x.dim())), keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def flash_eligible(query, key, value, attn_mask, is_causal, dropout_p=0.0):
    """The flash kernel's contract: CUDA tensors of one supported dtype
    (float32, bfloat16 or float16, as the JAX kernel takes any float),
    no mask and no attention dropout (as the JAX gate), a supported head
    dim, k/v heads dividing q
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
    if attn_mask is not None or dropout_p > 0.0:
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


def _keep_mask(p, shape, device, generator):
    """Bernoulli(1 - p) keep-mask of the attention probabilities, drawn
    from ``generator`` (the device's default generator when None)."""
    u = torch.rand(shape, device=device, generator=generator)
    return u >= p


@amp_op("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None, *,
                                 dropout_p=0.0, generator=None,
                                 is_causal=False, scale=None):
    """[batch, seq, heads, head_dim] attention. Calls that fit
    ``flash_eligible`` run the flash kernels through
    ``FlashAttentionFunction`` (forward kernel, and the backward kernels
    for the gradients of q, k and v); all others take the math
    form: f32 scores, a bottom-right aligned causal mask when
    ``is_causal`` (query i of sq sees keys j <= i + sk - sq), a bool
    keep-mask or an additive float mask, softmax, output cast back to
    the query's dtype. Key/value heads may divide the query heads (GQA):
    the math form repeats them.

    ``dropout_p`` > 0 drops each probability with that chance and scales
    the kept ones by 1 / (1 - p), as the JAX op does; the keep-mask is
    drawn from ``generator`` (a ``torch.Generator`` on the inputs'
    device, standing in for JAX's ``key_rng``; the default generator
    when None). Such a call takes the math form: the flash kernels keep
    no mask of their own, and the JAX gate refuses dropout too."""
    if flash_eligible(query, key, value, attn_mask, is_causal, dropout_p):
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
    if dropout_p > 0.0:
        keep = _keep_mask(dropout_p, probs.shape, probs.device, generator)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), device=probs.device))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2).to(query.dtype)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@amp_op("cross_entropy")
def cross_entropy(logits, label, weight=None, *, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Cross entropy over the class axis ``axis``, the JAX op's forms:

    * ``use_softmax`` (default): f32 log-softmax of ``logits``; False:
      ``logits`` are probabilities, and the log is taken of them clipped
      to at least 1e-30.
    * soft labels (``soft_label=True``, or ``label`` of the logits'
      shape): ``-sum(label * logp)`` over the class axis, after
      ``label * (1 - eps) + eps / n`` with ``label_smoothing`` eps; then
      the mean, the sum or each row (``reduction``); ``weight`` unused.
    * hard labels: integer class ids of the logits' shape without the
      class axis, or with it of size 1 (``[N, 1]``, squeezed). The
      label's log-probability, mixed with the mean log-probability of
      the row as ``(1 - eps) * -picked + eps * -mean(logp)`` under
      smoothing, times the class ``weight`` of the label; rows whose
      label is ``ignore_index`` give 0. ``"mean"`` divides the sum by the
      number of valid rows (at least 1), or with ``weight`` by the sum of
      the valid rows' weights (at least 1e-12).

    Unlike the JAX op, a hard-label call with ``axis`` other than the
    last gathers along ``axis`` (the JAX op gathers there from the wrong
    axis); with the class axis last both agree."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    ax = axis % logits.dim()
    lf = logits.float()
    if use_softmax:
        logp = torch.log_softmax(lf, dim=ax)
    else:
        logp = torch.log(lf.clamp_min(1e-30))
    n = logits.shape[ax]
    if soft_label or tuple(label.shape) == tuple(logits.shape):
        soft = label.float()
        if label_smoothing:
            soft = soft * (1 - label_smoothing) + label_smoothing / n
        return _reduce(-(soft * logp).sum(dim=ax), reduction)
    lab = label.squeeze(ax) if label.dim() == logits.dim() else label
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing:
        loss = ((1 - label_smoothing) * -picked
                - label_smoothing * logp.mean(dim=ax))
    else:
        loss = -picked
    if weight is not None:
        w = weight.float()[safe]
        loss = loss * w
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, w, torch.zeros_like(w)).sum()
            return loss.sum() / denom.clamp_min(1e-12)
        return loss.sum() / valid.sum().clamp(min=1).float()
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, *, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """``cross_entropy(..., reduction="none")`` with a trailing axis of 1;
    with ``return_softmax`` also the softmax of ``logits`` over
    ``axis``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(-1)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
