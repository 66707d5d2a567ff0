"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

Configuration carriers: the optimizer reads ``(kind, coeff)`` through
``optimizer._normalize_weight_decay`` and adds the gradient-coupled decay
(g += coeff * w for L2, coeff * sign(w) for L1) before its update rule.
A parameter's own ``regularizer`` attribute overrides its group's
``weight_decay``, under AdamW too.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    pass


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __str__(self):
        return f"L1Decay, coeff={self.coeff}"


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __str__(self):
        return f"L2Decay, coeff={self.coeff}"
