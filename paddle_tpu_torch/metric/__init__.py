"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``): ``Metric``,
``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and the
functional ``accuracy``. As in the JAX package they count on the host in
numpy: each ``compute`` / ``update`` reads its tensors back (one device
sync a call on the card)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np_of(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def accuracy(input, label, k=1):
    """Top-k accuracy of logits ``input`` [N, C] against ``label``: a
    float32 tensor [1] on the input's device."""
    logits = _np_of(input)
    y = _np_of(label).reshape(-1)
    topk = np.argsort(-logits, axis=-1)[:, :k]
    correct = (topk == y[:, None]).any(axis=1)
    device = input.device if isinstance(input, torch.Tensor) else None
    return torch.tensor([correct.mean()], dtype=torch.float32, device=device)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Optional pre-processing on tensors before update (ref Metric
        .compute); default passthrough."""
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        p = _np_of(pred)
        y = _np_of(label)
        if y.ndim > 1 and y.shape[-1] > 1:  # one-hot
            y = y.argmax(-1)
        y = y.reshape(-1)
        topk = np.argsort(-p, axis=-1)[:, : self.maxk]
        return (topk == y[:, None]).astype(np.float32)

    def update(self, correct, *args):
        correct = _np_of(correct)
        for i, k in enumerate(self.topk):
            hit = correct[:, :k].any(axis=1)
            self.total[i] += hit.sum()
            self.count[i] += len(hit)
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision over thresholded predictions (ref metrics.py)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np_of(preds).reshape(-1) > 0.5).astype(np.int64)
        y = _np_of(labels).reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fp += int(((p == 1) & (y == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np_of(preds).reshape(-1) > 0.5).astype(np.int64)
        y = _np_of(labels).reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fn += int(((p == 0) & (y == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via thresholded confusion bins (ref metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np_of(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        y = _np_of(labels).reshape(-1)
        idx = np.clip(
            (p * self.num_thresholds).astype(np.int64),
            0, self.num_thresholds,
        )
        n = self.num_thresholds + 1
        pos_mask = y.astype(bool)
        self._stat_pos += np.bincount(idx[pos_mask], minlength=n)
        self._stat_neg += np.bincount(idx[~pos_mask], minlength=n)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # sweep thresholds from high to low accumulating TPR/FPR trapezoids
        pos = self._stat_pos[::-1].cumsum()
        neg = self._stat_neg[::-1].cumsum()
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name
