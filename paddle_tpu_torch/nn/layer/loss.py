"""Loss layers of the port (``paddle_tpu/nn/layer/loss.py``)."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class CrossEntropyLoss(nn.Module):
    """:func:`paddle_tpu_torch.nn.functional.cross_entropy` with its
    arguments fixed at construction."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False, axis=-1,
                 use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight, self.ignore_index, self.reduction = weight, ignore_index, reduction
        self.soft_label, self.axis, self.use_softmax = soft_label, axis, use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index, self.reduction,
                               self.soft_label, self.axis, self.use_softmax, self.label_smoothing)
