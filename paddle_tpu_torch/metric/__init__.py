"""Metrics of the port (``paddle_tpu/metric/__init__.py``; parity:
python/paddle/metric/metrics.py: Metric, Accuracy, Precision, Recall, Auc,
and the accuracy and auc operators).

Each ``compute``/``update`` runs in torch on the device its inputs lie on
(the card on the main path); the accumulators are host numbers, as in the
reference, so ``update`` reads a few scalars back, and nothing copies a
``[b, s, V]`` logits tensor to the host (the reference sorts it there with
``np.argsort``).

Top-k ties: a label is ranked by the count of scores above its own plus the
count of equal scores at lower class indices, so among equal scores the
lower index ranks first (a stable descending sort's order). The reference's
``np.argsort(-p)`` leaves their order to the sort (bf16 logits tie often);
without ties both give the same results.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _labels(pred, label):
    """``label`` as class indices of ``pred``'s leading shape (a trailing
    dim of 1 dropped)."""
    label = _tensor(label).to(pred.device)
    if label.ndim == pred.ndim and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return label.long()


def _topk_correct(pred, label, maxk):
    """``[..., maxk]`` booleans: entry j says the label ranks j-th (see the
    module's docstring for ties)."""
    p = _tensor(pred)
    label = _labels(p, label)
    own = p.gather(-1, label.unsqueeze(-1))
    index = torch.arange(p.shape[-1], device=p.device)
    rank = ((p > own) | ((p == own) & (index < label.unsqueeze(-1)))).sum(-1)
    return rank.unsqueeze(-1) == torch.arange(maxk, device=p.device)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return type(self).__name__.lower()

    def compute(self, pred, label):
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``; ``accumulate`` returns one
    float, or a list for several k."""

    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label):
        return _topk_correct(pred, label, max(self.topk)), None

    def update(self, correct, _=None):
        c = _tensor(correct)
        hits = torch.stack([c[..., :k].any(dim=-1).sum() for k in self.topk]).tolist()
        n = c[..., 0].numel()
        for i, h in enumerate(hits):
            self.total[i] += h
            self.count[i] += n
        return self.accumulate()

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


def _binary(preds, labels):
    p = (_tensor(preds) > 0.5).reshape(-1)
    lab = _tensor(labels).to(p.device).long().reshape(-1)
    return p, lab


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p, lab = _binary(preds, labels)
        tp, fp = torch.stack([(p & (lab == 1)).sum(), (p & (lab == 0)).sum()]).tolist()
        self.tp += tp
        self.fp += fp

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p, lab = _binary(preds, labels)
        tp, fn = torch.stack([(p & (lab == 1)).sum(), (~p & (lab == 1)).sum()]).tolist()
        self.tp += tp
        self.fn += fn

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """Trapezoid AUC over ``num_thresholds`` bins (parity:
    operators/metrics/auc_op): each batch's bin counts by ``bincount`` on its
    device, added to host arrays."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self.num_thresholds = num_thresholds
        self._name = name or "auc"
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _tensor(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        pos = _tensor(labels).to(p.device).reshape(-1) != 0
        n = self.num_thresholds
        bins = (p * n).long().clamp(0, n)
        counts = torch.stack([torch.bincount(bins[pos], minlength=n + 1),
                              torch.bincount(bins[~pos], minlength=n + 1)]).cpu().numpy()
        self._stat_pos += counts[0]
        self._stat_neg += counts[1]

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # accumulate from the highest threshold down
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        return float(np.trapezoid(tp / tot_pos, fp / tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of one batch as an f32 scalar tensor on the
    input's device (parity: python/paddle/metric/metrics.py:789)."""
    return _topk_correct(input, label, k).any(dim=-1).float().mean()
