"""LeNet of the port (``paddle_tpu/models/lenet.py``), as
``bench_suite.py:bench_mnist`` trains it on ``[N, 1, 28, 28]`` images."""
from __future__ import annotations

import torch
from torch import nn

from ..framework.device import resolve_device
from ..nn.layer import Conv2D, Linear, MaxPool2D, ReLU


class LeNet(nn.Module):
    """Two convolutions with ReLU and 2 x 2 max pools, then three ``Linear``
    layers (no activation between them, as in the reference). Random
    weights are drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (None: the card)."""

    def __init__(self, num_classes=10, *, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        made = dict(device=device, generator=torch.Generator(device=device).manual_seed(int(seed)))
        self.features = nn.Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **made), ReLU(), MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **made), ReLU(), MaxPool2D(2, 2))
        self.fc = nn.Sequential(Linear(400, 120, **made), Linear(120, 84, **made),
                                Linear(84, num_classes, **made))

    def forward(self, x):
        return self.fc(torch.flatten(self.features(x), 1))
