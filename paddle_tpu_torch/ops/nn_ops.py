"""The nn ops: linear, convolution, pooling, normalisation, attention,
dropout and loss.

Counterpart of ``paddle_tpu/ops/impl/nn_ops.py``: ``rms_norm``,
``scaled_dot_product_attention`` (with attention dropout),
``cross_entropy`` in all its forms and ``softmax_with_cross_entropy``
(the Llama and DiT paths), and the ops of the ``nn`` layer set (after
them, from ``linear`` on). Layouts follow the JAX package: attention
tensors are [batch, seq, heads, head_dim], convolutions and pools are
channel-first unless ``data_format`` says otherwise, a ``linear`` weight
is [in, out]. The JAX package computes the layer set's ops as XLA ops
(``conv_general_dilated``, ``reduce_window``, jnp); their counterparts
here are torch ops (cuDNN for the convolutions on the card). Each op
that the JAX package dispatches as one op is one op of the
``amp.auto_cast`` policy, by its name (``amp_op``): its float tensor
arguments are cast as the policy says and its body runs as written.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..amp.auto_cast import amp_op
from ..kernels import _build
from ..kernels import flash_attention as _flash

__all__ = [
    "rms_norm", "scaled_dot_product_attention", "flash_eligible",
    "cross_entropy", "softmax_with_cross_entropy",
    "linear", "bilinear", "embedding",
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
    "max_pool2d_with_index",
    "batch_norm", "batch_norm_with_stats", "layer_norm", "instance_norm",
    "group_norm", "local_response_norm", "normalize",
    "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "mse_loss", "l1_loss", "smooth_l1_loss", "nll_loss", "kl_div",
    "hinge_embedding_loss", "margin_ranking_loss", "cosine_embedding_loss",
    "triplet_margin_loss", "log_loss", "square_error_cost", "ctc_loss",
    "cosine_similarity", "label_smooth", "pixel_shuffle", "pixel_unshuffle",
    "unfold", "interpolate", "upsample", "affine_grid", "grid_sample",
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
    every eligible call runs the kernel. A fake tensor (the static
    analyzer's trace) on any device is held to the same contract, so a
    trace on the CPU takes the route the card takes."""
    if query.device.type != "cuda" and not _build.is_fake(query):
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
    the flash ops (forward kernel, and the backward kernels
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


# ---- linear ----------------------------------------------------------------
@amp_op("linear")
def linear(x, weight, bias=None):
    """``x @ weight + bias`` with the JAX package's [in, out] weight."""
    return F.linear(x, weight.t(), bias)


def bilinear(x1, x2, weight, bias=None):
    """``out[n, o] = x1[n] @ weight[o] @ x2[n] + bias``."""
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


@amp_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at ``x``; the rows of ``padding_idx`` come out 0
    (and pass no gradient), whatever the weight holds there."""
    out = F.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


# ---- convolutions ----------------------------------------------------------
_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    return v * n if len(v) == 1 else v


def _pad_pairs(padding, n):
    """The JAX package's padding forms: "SAME" or "VALID" (returned as
    is), an int, n ints, 2n ints (low, high per axis) or n pairs."""
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"bad padding: {padding}")
        return p
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    ints = all(isinstance(p, (int, np.integer)) for p in padding)
    if ints and len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if ints and len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if len(padding) == n and all(isinstance(p, (list, tuple))
                                 for p in padding):
        return [tuple(int(v) for v in p) for p in padding]
    raise ValueError(f"bad padding: {padding}")


def _same_pairs(sizes, kernel, stride, dilation):
    """XLA's SAME: out = ceil(size / stride), total padding
    max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0), the low
    side taking total // 2."""
    pairs = []
    for h, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-h // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - h, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def _resolve_pairs(padding, sizes, kernel, stride, dilation):
    pairs = _pad_pairs(padding, len(kernel))
    if pairs == "VALID":
        return [(0, 0)] * len(kernel)
    if pairs == "SAME":
        return _same_pairs(sizes, kernel, stride, dilation)
    return pairs


def _flat(pairs):
    """(low, high) pairs of the leading spatial axis first -> F.pad's
    list, the last axis first."""
    return [v for lo, hi in reversed(pairs) for v in (lo, hi)]


def _to_channel_first(x, data_format):
    return x.movedim(-1, 1) if data_format in _CHANNEL_LAST else x


def _from_channel_first(x, data_format):
    return x.movedim(1, -1) if data_format in _CHANNEL_LAST else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, n):
    """Convolution with a [out, in / groups, *k] weight. torch pads both
    sides of an axis alike, so unequal (low, high) pairs, and SAME where
    it comes out uneven, are padded with zeros first."""
    x = _to_channel_first(x, data_format)
    stride, dilation = _ntuple(stride, n), _ntuple(dilation, n)
    pairs = _resolve_pairs(padding, x.shape[2:], weight.shape[2:], stride,
                           dilation)
    if all(lo == hi for lo, hi in pairs):
        pad = tuple(lo for lo, _ in pairs)
    else:
        x = F.pad(x, _flat(pairs))
        pad = 0
    out = _CONV[n](x, weight, bias, stride, pad, dilation, groups)
    return _from_channel_first(out, data_format)


@amp_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


@amp_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2)


@amp_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       groups, dilation, data_format, n):
    """Transposed convolution with an [in, out / groups, *k] weight, the
    JAX package's output shape: (h - 1) * stride + (k - 1) * dilation + 1
    - low - high + output_padding for (low, high) pairs. torch takes only
    equal pairs and an output_padding below the stride or dilation; other
    calls run with none and are then cropped (or zero-padded) to the JAX
    shape, the bias added after."""
    if isinstance(padding, str):
        raise ValueError(
            "string padding is not supported for a transposed convolution "
            "(the JAX op refuses it too); give the padding as numbers")
    x = _to_channel_first(x, data_format)
    stride, dilation = _ntuple(stride, n), _ntuple(dilation, n)
    pairs = _pad_pairs(padding, n)
    out_pad = _ntuple(output_padding, n)
    if (all(lo == hi >= 0 for lo, hi in pairs)
            and all(op < max(s, d) for op, s, d in zip(out_pad, stride,
                                                       dilation))):
        out = _CONV_T[n](x, weight, bias, stride,
                         tuple(lo for lo, _ in pairs), out_pad, groups,
                         dilation)
        return _from_channel_first(out, data_format)
    out = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
    out = F.pad(out, _flat([(-lo, op - hi)
                            for (lo, hi), op in zip(pairs, out_pad)]))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return _from_channel_first(out, data_format)


@amp_op("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, data_format,
                              1)


@amp_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, data_format,
                              2)


@amp_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, data_format,
                              3)


# ---- pooling ---------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _ceil_extra(size, k, s, lo, hi):
    """High padding ``ceil_mode`` adds: the output is ceil((L - k) / s) + 1
    windows over L = size + lo + hi, less the last one where it would
    start in the high padding (every window covers an input element)."""
    length = size + lo + hi
    out = -(-(length - k) // s) + 1
    if (out - 1) * s >= size + lo:
        out -= 1
    return max((out - 1) * s + k - length, 0)


def _pool_geometry(x, kernel_size, stride, padding, ceil_mode, n):
    """(k, s, pairs, extras): the window, the stride, the (low, high)
    padding of each spatial axis, and the high padding ceil mode adds."""
    k = _ntuple(kernel_size, n)
    s = _ntuple(stride if stride is not None else kernel_size, n)
    pairs = _resolve_pairs(padding, x.shape[2:], k, s, (1,) * n)
    extras = [_ceil_extra(h, kk, ss, lo, hi) if ceil_mode else 0
              for h, kk, ss, (lo, hi) in zip(x.shape[2:], k, s, pairs)]
    return k, s, pairs, extras


def _native_pad(k, pairs):
    """The padding torch's pools take (each side alike, at most half the
    window), or None."""
    if all(lo == hi and 0 <= lo <= kk // 2 for kk, (lo, hi) in zip(k, pairs)):
        return tuple(lo for lo, _ in pairs)
    return None


def _max_pool_nd(x, kernel_size, stride, padding, ceil_mode, data_format,
                 n):
    """Max over each window; padding never wins. Unlike the JAX op (which
    ignores it), ``ceil_mode`` is honoured (``_ceil_extra``)."""
    x = _to_channel_first(x, data_format)
    k, s, pairs, extras = _pool_geometry(x, kernel_size, stride, padding,
                                         ceil_mode, n)
    native = _native_pad(k, pairs)
    if native is not None:
        out = _MAX_POOL[n](x, k, s, native, ceil_mode=ceil_mode)
    else:
        xp = F.pad(x, _flat([(lo, hi + e) for (lo, hi), e in
                             zip(pairs, extras)]), value=float("-inf"))
        out = _MAX_POOL[n](xp, k, s)
    return _from_channel_first(out, data_format)


def _avg_pool_nd(x, kernel_size, stride, padding, ceil_mode,
                 count_include_pad, data_format, n):
    """Mean over each window: with ``count_include_pad`` the padding's
    zeros count (not the cells ceil mode adds past it), else only input
    cells."""
    x = _to_channel_first(x, data_format)
    k, s, pairs, extras = _pool_geometry(x, kernel_size, stride, padding,
                                         ceil_mode, n)
    native = _native_pad(k, pairs)
    if native is not None:
        out = _AVG_POOL[n](x, k, s, native, ceil_mode=ceil_mode,
                           count_include_pad=count_include_pad)
        return _from_channel_first(out, data_format)
    full = [(lo, hi + e) for (lo, hi), e in zip(pairs, extras)]
    out = _AVG_POOL[n](F.pad(x, _flat(full)), k, s)
    if count_include_pad and not any(extras):
        return _from_channel_first(out, data_format)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if count_include_pad:
        ones = F.pad(ones, _flat(pairs), value=1.0)
        ones = F.pad(ones, _flat([(0, e) for e in extras]))
    else:
        ones = F.pad(ones, _flat(full))
    return _from_channel_first(out / _AVG_POOL[n](ones, k, s), data_format)


@amp_op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCL"):
    return _max_pool_nd(x, kernel_size, stride, padding, ceil_mode,
                        data_format, 1)


@amp_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _max_pool_nd(x, kernel_size, stride, padding, ceil_mode,
                        data_format, 2)


@amp_op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    return _max_pool_nd(x, kernel_size, stride, padding, ceil_mode,
                        data_format, 3)


@amp_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, data_format="NCL"):
    return _avg_pool_nd(x, kernel_size, stride, padding, ceil_mode,
                        count_include_pad, data_format, 1)


@amp_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, data_format="NCHW"):
    return _avg_pool_nd(x, kernel_size, stride, padding, ceil_mode,
                        count_include_pad, data_format, 2)


@amp_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, data_format="NCDHW"):
    return _avg_pool_nd(x, kernel_size, stride, padding, ceil_mode,
                        count_include_pad, data_format, 3)


@amp_op("max_pool2d_with_index")
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          ceil_mode=False, data_format="NCHW"):
    """(out, mask): ``mask`` holds, for each output cell, the flat index
    over the input's H * W of the window's maximum (torch's
    ``return_indices`` convention, int64), the first one on a tie."""
    if data_format != "NCHW":
        raise ValueError("max_pool2d_with_index requires NCHW")
    if isinstance(padding, str):
        raise ValueError("string padding unsupported for return_mask")
    k, s, pairs, extras = _pool_geometry(x, kernel_size, stride, padding,
                                         ceil_mode, 2)
    native = _native_pad(k, pairs)
    if native is not None:
        return F.max_pool2d(x, k, s, native, ceil_mode=ceil_mode,
                            return_indices=True)
    xp = F.pad(x, _flat([(lo, hi + e) for (lo, hi), e in
                         zip(pairs, extras)]), value=float("-inf"))
    out, idx = F.max_pool2d(xp, k, s, return_indices=True)
    wp = xp.shape[-1]
    iy = idx // wp - pairs[0][0]
    ix = idx % wp - pairs[1][0]
    return out, iy * x.shape[-1] + ix


@amp_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size):
    """Means over the buckets [floor(i L / out), ceil((i + 1) L / out))."""
    return F.adaptive_avg_pool1d(x, _ntuple(output_size, 1))


@amp_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    x = _to_channel_first(x, data_format)
    out = F.adaptive_avg_pool2d(x, _ntuple(output_size, 2))
    return _from_channel_first(out, data_format)


@amp_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    x = _to_channel_first(x, data_format)
    out = F.adaptive_max_pool2d(x, _ntuple(output_size, 2))
    return _from_channel_first(out, data_format)


# ---- normalisation ---------------------------------------------------------
def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") else x.dim() - 1


def _per_channel(t, x, c_axis):
    shape = [1] * x.dim()
    shape[c_axis] = -1
    return t.reshape(shape)


def _batch_stats(x, weight, bias, epsilon, c_axis):
    """The training form's output and the batch's f32 mean and biased
    variance over every axis but the channel's."""
    if c_axis != 1:
        x = x.movedim(c_axis, 1)
    out, mean, invstd = torch.native_batch_norm(
        x, weight, bias, None, None, True, 0.0, epsilon)
    with torch.no_grad():
        if mean.dtype in (torch.bfloat16, torch.float16):
            # the CPU keeps a 16-bit input's statistics in its own dtype
            var, mean = torch.var_mean(
                x.float(), dim=[i for i in range(x.dim()) if i != 1],
                correction=0)
        else:
            var = invstd.pow(-2).sub_(epsilon)
    if c_axis != 1:
        out = out.movedim(1, c_axis)
    return out, mean, var


@amp_op("batch_norm_with_stats")
def _batch_norm_train(x, weight=None, bias=None, *, epsilon, c_axis):
    return _batch_stats(x, weight, bias, epsilon, c_axis)


def batch_norm_with_stats(x, running_mean, running_var, weight=None,
                          bias=None, momentum=0.9, epsilon=1e-5,
                          data_format="NCHW"):
    """(out, new_running_mean, new_running_var): ``x`` normalised by its
    batch's statistics (f32, the biased variance, the normalised value
    in x's dtype before the scale and bias), and the running statistics
    as the JAX op updates them, ``momentum * running + (1 - momentum) *
    batch``. torch's ``batch_norm`` differs on both counts (it weights
    the batch by ``momentum`` and keeps the unbiased variance), so the
    update is computed here; the inputs are not changed. The running
    statistics stay in their own dtype (f32 for the layers') under
    ``auto_cast``."""
    out, mean, var = _batch_norm_train(
        x, weight, bias, epsilon=epsilon,
        c_axis=_channel_axis(x, data_format))
    with torch.no_grad():
        new_mean = torch.lerp(running_mean, mean.to(running_mean.dtype),
                              1.0 - momentum)
        new_var = torch.lerp(running_var, var.to(running_var.dtype),
                             1.0 - momentum)
    return out, new_mean, new_var


@amp_op("batch_norm")
def _batch_norm_infer(x, running_mean, running_var, weight=None, bias=None,
                      *, epsilon, c_axis):
    """``(x - running_mean) / sqrt(running_var + eps) * weight + bias`` in
    x's dtype."""
    if c_axis != 1:
        x = x.movedim(c_axis, 1)
    dt = weight.dtype if weight is not None else x.dtype
    out = F.batch_norm(x, running_mean.to(dt), running_var.to(dt), weight,
                       bias, False, 0.0, epsilon)
    return out.movedim(1, c_axis) if c_axis != 1 else out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=False):
    """The batch's statistics when ``training`` (unless
    ``use_global_stats``), else the running ones. The running statistics
    are never updated here: the ``BatchNorm`` layers own them and call
    ``batch_norm_with_stats``."""
    c_axis = _channel_axis(x, data_format)
    if training and not use_global_stats:
        return _batch_norm_train(x, weight, bias, epsilon=epsilon,
                                 c_axis=c_axis)[0]
    return _batch_norm_infer(x, running_mean, running_var, weight, bias,
                             epsilon=epsilon, c_axis=c_axis)


@amp_op("layer_norm")
def layer_norm(x, weight=None, bias=None, normalized_shape=None,
               epsilon=1e-5):
    """Over the last ``len(normalized_shape)`` axes (the last one when
    None): f32 statistics, the normalised value cast back to x's dtype,
    then the scale and the bias."""
    k = (1 if normalized_shape is None else
         len(normalized_shape) if isinstance(normalized_shape, (list, tuple))
         else 1)
    dims = tuple(range(x.dim() - k, x.dim()))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@amp_op("instance_norm")
def instance_norm(x, weight=None, bias=None, epsilon=1e-5,
                  data_format="NCHW"):
    """Each sample's channels over their spatial axes, in x's dtype."""
    c_axis = _channel_axis(x, data_format)
    dims = (tuple(range(2, x.dim())) if c_axis == 1
            else tuple(range(1, x.dim() - 1)))
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * _per_channel(weight, x, c_axis)
    if bias is not None:
        out = out + _per_channel(bias, x, c_axis)
    return out


@amp_op("group_norm")
def group_norm(x, weight=None, bias=None, num_groups=1, epsilon=1e-5,
               data_format="NCHW"):
    """Each sample's channel groups over the group's channels and the
    spatial axes, in x's dtype."""
    x = x if data_format.startswith("NC") else x.movedim(-1, 1)
    n, c = x.shape[:2]
    spatial = tuple(x.shape[2:])
    g = x.reshape((n, num_groups, c // num_groups) + spatial)
    var, mean = torch.var_mean(g, dim=tuple(range(2, g.dim())),
                               keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(
        (n, c) + spatial)
    if weight is not None:
        out = out * _per_channel(weight, out, 1)
    if bias is not None:
        out = out + _per_channel(bias, out, 1)
    return out if data_format.startswith("NC") else out.movedim(1, -1)


@amp_op("local_response_norm")
def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """``x / (k + alpha * sum of x^2 over ``size`` neighbouring
    channels) ** beta``, the window from size // 2 below to the rest
    above (not divided by ``size``, as in the JAX op)."""
    c_axis = _channel_axis(x, data_format)
    sq = x.square().movedim(c_axis, 0)
    half = size // 2
    c = sq.shape[0]
    padded = F.pad(sq.movedim(0, -1), (half, size - 1 - half)).movedim(-1, 0)
    acc = sum(padded[i:i + c] for i in range(size))
    denom = (k + alpha * acc) ** beta
    return x / denom.movedim(0, c_axis)


def normalize(x, p=2.0, axis=1, epsilon=1e-12):
    """``x`` over its ``p``-norm along ``axis``, the norm at least
    ``epsilon``."""
    denom = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / denom.clamp_min(epsilon)


# ---- dropout ---------------------------------------------------------------
def _keep(x, p, shape, generator):
    return torch.rand(shape, device=x.device, generator=generator) >= p


def dropout(x, p=0.5, training=True, mode="upscale_in_train", axis=None,
            *, generator=None):
    """Zero each element (each slice along the axes not in ``axis``, when
    given) with chance ``p``; "upscale_in_train" scales the kept ones by
    1 / (1 - p), "downscale_in_infer" scales by 1 - p outside training.
    The keep-mask is drawn from ``generator`` (the device's default
    generator when None), standing in for the JAX package's PRNG key."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = _keep(x, p, shape, generator)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", *,
              generator=None):
    """Whole channels of a 4-D input."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, training, axis=axis, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", *,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, training, axis=axis, generator=generator)


def alpha_dropout(x, p=0.5, training=True, *, generator=None):
    """SELU-preserving dropout: dropped elements take SELU's negative
    saturation, then an affine map restores mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _keep(x, p, x.shape, generator)
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    fill = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return a * torch.where(keep, x, fill) + b


# ---- losses ----------------------------------------------------------------
@amp_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(input.clamp_min(eps))
             + (1 - label) * torch.log((1 - input).clamp_min(eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("sigmoid_cross_entropy_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     pos_weight=None, reduction="mean"):
    max_val = (-logit).clamp_min(0)
    soft = torch.log1p(torch.exp(-logit.abs())) + max_val
    if pos_weight is not None:
        loss = (1 - label) * logit + ((pos_weight - 1) * label + 1) * soft
    else:
        loss = (1 - label) * logit + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean"):
    return _reduce((input - label).square(), reduction)


def l1_loss(input, label, reduction="mean"):
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    diff = (input - label).abs()
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


@amp_op("nll_loss")
def nll_loss(log_prob, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """``-log_prob`` at the label along the last axis, times the class
    weight; ``ignore_index`` rows give 0 and ``"mean"`` divides by the
    valid rows (or their weights), at least 1e-12."""
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -log_prob.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    w = weight[safe] if weight is not None else None
    if w is not None:
        loss = loss * w
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        denom = (torch.where(valid, w, zero).sum() if w is not None
                 else valid.sum().to(loss.dtype))
        return loss.sum() / denom.clamp_min(1e-12)
    return _reduce(loss, reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1, input, (margin - input).clamp_min(0))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce((-label * (input - other) + margin).clamp_min(0),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = (input1 * input2).sum(-1) / (
        input1.norm(dim=-1) * input2.norm(dim=-1) + 1e-12)
    loss = torch.where(label == 1, 1 - cos, (cos - margin).clamp_min(0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        reduction="mean"):
    d_pos = ((input - positive).abs() ** p).sum(-1) ** (1 / p)
    d_neg = ((input - negative).abs() ** p).sum(-1) ** (1 / p)
    return _reduce((d_pos - d_neg + margin).clamp_min(0), reduction)


def log_loss(input, label, epsilon=1e-4):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def square_error_cost(input, label):
    return (input - label).square()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over time-major ``log_probs`` [T, B, C] (log-softmaxed here, in
    f32) and padded ``labels`` [B, L]: the JAX op's alpha recursion in log
    space, one step per frame, autograd giving the gradient. The loss
    reads each sequence's alpha at its last valid frame; ``"mean"``
    divides each by its label length (at least 1), as the JAX op and
    torch do."""
    t_len, b, _ = log_probs.shape
    s = 2 * labels.shape[1] + 1
    neg_inf = -1e30
    dev = log_probs.device
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    labels = labels.long()
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    prev_lab = torch.cat([torch.full((b, 2), -1, dtype=torch.long,
                                     device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != prev_lab)
    states = torch.arange(s, device=dev)[None, :]
    smask = states < (2 * label_lengths.long() + 1)[:, None]
    fill = torch.full((), neg_inf, device=dev)
    alpha = torch.where((states < 2) & smask, lp[0].gather(1, ext), fill)
    alphas = [alpha]
    pad1 = torch.full((b, 1), neg_inf, device=dev)
    pad2 = torch.full((b, 2), neg_inf, device=dev)
    for t in range(1, t_len):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]],
                                                dim=1), fill)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        alpha = torch.where(smask, merged + lp[t].gather(1, ext), fill)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    t_idx = (input_lengths.long() - 1).clamp(0, t_len - 1)
    last = alphas[t_idx, torch.arange(b, device=dev)]
    s_last = 2 * label_lengths.long()
    a_blank = last.gather(1, s_last[:, None])[:, 0]
    a_label = last.gather(1, (s_last - 1).clamp_min(0)[:, None])[:, 0]
    a_label = torch.where(label_lengths > 0, a_label, fill)
    nll = -torch.logaddexp(a_blank, a_label)
    if norm_by_times:
        nll = nll / input_lengths.float().clamp_min(1.0)
    if reduction == "mean":
        return (nll / label_lengths.float().clamp_min(1.0)).mean()
    if reduction == "sum":
        return nll.sum()
    return nll


# ---- misc ------------------------------------------------------------------
@amp_op("cos_sim")
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    return dot / (x1.norm(dim=axis) * x2.norm(dim=axis)).clamp_min(eps)


def label_smooth(label, epsilon=0.1):
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    """[n, c r^2, h, w] -> [n, c, h r, w r] (channel-first)."""
    return F.pixel_shuffle(x, upscale_factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    return F.pixel_unshuffle(x, downscale_factor)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """Sliding [c * kh * kw] columns of an NCHW input: [n, c kh kw, L]."""
    k, s, d = (_ntuple(kernel_sizes, 2), _ntuple(strides, 2),
               _ntuple(dilations, 2))
    pairs = _resolve_pairs(paddings, x.shape[2:], k, s, d)
    return F.unfold(F.pad(x, _flat(pairs)), k, dilation=d, stride=s)


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (``jax.image.resize``'s
    "cubic")."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _resize_weights(n_in, n_out, kernel):
    """[n_in, n_out] weights of one axis as ``jax.image.resize`` builds
    them: half-pixel centres, the kernel widened by in / out when
    shrinking (antialiasing), each column normalised to sum 1, zero for
    samples outside the input."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = kernel(np.abs(sample[None, :] - np.arange(n_in)[:, None])
               / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize_separable(x, size, kernel):
    """``jax.image.resize`` with ``kernel`` over every spatial axis whose
    size changes: one f32 product with that axis's weight matrix each."""
    out = x.float()
    for dim, (n, o) in enumerate(zip(x.shape[2:], size)):
        if n == o:
            continue
        w = torch.from_numpy(_resize_weights(n, o, kernel)).to(out.device)
        out = torch.movedim(torch.tensordot(out, w, dims=([2 + dim], [0])),
                            -1, 2 + dim)
    return out.to(x.dtype)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW", name=None):
    """Resize the spatial axes of a channel-first input, as the JAX op.
    "nearest" takes index floor(i * in / out); every other mode with
    ``align_corners`` interpolates linearly between the corner-aligned
    grid points (the JAX op does so for "bicubic" and "area" too).
    Without it, ``jax.image.resize``'s weights, one matrix a resized
    axis (half-pixel centres, the filter widened by the scale when
    shrinking): the linear modes and "area" its "linear" (a triangle
    filter; "area" is not torch's adaptive average pooling), "bicubic"
    its "cubic" (Keys' a = -0.5; torch's bicubic is a = -0.75)."""
    if data_format not in ("NCHW", "NCL", "NCDHW"):
        raise NotImplementedError("interpolate expects channel-first")
    spatial = x.shape[2:]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(n * f) for n, f in zip(spatial, scale_factor)]
    size = [int(v) for v in (size if isinstance(size, (list, tuple))
                             else [size])]
    if mode == "nearest":
        out = x
        for dim, (n, o) in enumerate(zip(spatial, size)):
            idx = torch.floor(torch.arange(o, device=x.device) * (n / o))
            out = out.index_select(2 + dim, idx.long())
        return out
    if mode not in ("linear", "bilinear", "trilinear", "bicubic", "area"):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    if align_corners:
        out = x.float()
        for dim, (n, o) in enumerate(zip(spatial, size)):
            pos = torch.linspace(0.0, n - 1, o, device=x.device)
            lo = pos.floor().long()
            hi = (lo + 1).clamp(max=n - 1)
            shape = [1] * out.dim()
            shape[2 + dim] = -1
            frac = (pos - lo).reshape(shape)
            a = out.index_select(2 + dim, lo)
            b = out.index_select(2 + dim, hi)
            out = a * (1 - frac) + b * frac
        return out.to(x.dtype)
    return _resize_separable(
        x, size, _keys_cubic if mode == "bicubic" else _triangle)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    """``interpolate``."""
    return interpolate(x, size, scale_factor, mode, align_corners,
                       data_format)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Sampling grid of an affine map, as the JAX op: theta [N, 2, 3] ->
    [N, H, W, 2] for a 4-D ``out_shape`` [N, C, H, W], [N, 3, 4] ->
    [N, D, H, W, 3] for a 5-D one; coordinates in [-1, 1] at the
    corners (``align_corners``) or at the pixel centres."""
    out_shape = [int(v) for v in out_shape]
    dt, dev = theta.dtype, theta.device

    def coords(n):
        if align_corners:
            if n == 1:
                return torch.zeros(1, dtype=dt, device=dev)
            return torch.linspace(-1.0, 1.0, n, device=dev).to(dt)
        return ((torch.arange(n, device=dev) * 2 + 1) / n - 1.0).to(dt)

    if len(out_shape) == 4:
        _, _, h, w = out_shape
        gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum("hwk,nok->nhwo", base, theta)
    if len(out_shape) == 5:
        _, _, d, h, w = out_shape
        gz, gy, gx = torch.meshgrid(coords(d), coords(h), coords(w),
                                    indexing="ij")
        base = torch.stack([gx, gy, gz, torch.ones_like(gx)], dim=-1)
        return torch.einsum("dhwk,nok->ndhwo", base, theta)
    raise ValueError(
        f"affine_grid expects a 4-D or 5-D out_shape, got {out_shape}")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Bilinear samples of x [N, C, H, W] at grid [N, Ho, Wo, 2] ((x, y)
    in [-1, 1]) -> [N, C, Ho, Wo], as the JAX op computes it: the JAX op
    samples bilinearly whatever ``mode`` says, and a corner outside the
    image reads as 0 under ``padding_mode="zeros"`` and as the nearest
    edge pixel under any other mode (its "border"; "reflection" is not
    reflected there either)."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * (w - 1) / 2
        fy = (gy + 1) * (h - 1) / 2
    else:
        fx = ((gx + 1) * w - 1) / 2
        fy = ((gy + 1) * h - 1) / 2
    x0, y0 = fx.floor().long(), fy.floor().long()
    wx, wy = (fx - x0).unsqueeze(1), (fy - y0).unsqueeze(1)
    flat = x.reshape(n, c, h * w)

    def gather(yy, xx):
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        out = flat.gather(2, idx.reshape(n, 1, -1).expand(n, c, -1))
        out = out.reshape(n, c, *yy.shape[1:])
        if padding_mode == "zeros":
            valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            out = out * valid.unsqueeze(1).to(out.dtype)
        return out

    return (gather(y0, x0) * (1 - wx) * (1 - wy)
            + gather(y0, x0 + 1) * wx * (1 - wy)
            + gather(y0 + 1, x0) * (1 - wx) * wy
            + gather(y0 + 1, x0 + 1) * wx * wy)
