"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``) over the
port's loss ops."""
from __future__ import annotations

from ... import ops as F
from .layers import Layer

__all__ = [
    "CTCLoss",
    "BCELoss", "BCEWithLogitsLoss", "CrossEntropyLoss", "CosineEmbeddingLoss",
    "HingeEmbeddingLoss", "KLDivLoss", "L1Loss", "MarginRankingLoss",
    "MSELoss", "NLLLoss", "SmoothL1Loss", "TripletMarginLoss",
]


def _check_reduction(reduction):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(
            f"reduction must be 'mean'|'sum'|'none', got {reduction!r}"
        )


class CrossEntropyLoss(Layer):
    """``ops.cross_entropy``: soft labels, ``ignore_index``, label
    smoothing, class weights, the class axis."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        _check_reduction(reduction)
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing,
        )


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        _check_reduction(reduction)
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        _check_reduction(reduction)
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        _check_reduction(reduction)
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(
            input, label, self.weight, self.ignore_index, self.reduction
        )


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        _check_reduction(reduction)
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        _check_reduction(reduction)
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.pos_weight, self.reduction
        )


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction = reduction
        self.log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        _check_reduction(reduction)
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        _check_reduction(reduction)
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(
            input, other, label, self.margin, self.reduction
        )


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        _check_reduction(reduction)
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(
            input1, input2, label, self.margin, self.reduction
        )


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        _check_reduction(reduction)
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(
            input, label, self.margin, self.reduction
        )


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        _check_reduction(reduction)
        self.margin = margin
        self.p = p
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(
            input, positive, negative, self.margin, self.p, self.reduction
        )


class CTCLoss(Layer):
    """``ops.ctc_loss`` over time-major log-probabilities [T, B, C]."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        _check_reduction(reduction)
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(
            log_probs, labels, input_lengths, label_lengths,
            blank=self.blank, reduction=self.reduction,
            norm_by_times=norm_by_times,
        )
