"""AlexNet of the port (``paddle_tpu/vision/models/alexnet.py``), with the
reference's module names, so a state carries across by name. Its head
takes the 6 x 6 maps of a 224 x 224 input."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import Conv2D, Dropout, Linear, MaxPool2D, ReLU
from ._common import made, refuse_pretrained


class AlexNet(nn.Module):
    """Five convolutions (11 x 11 stride 4, 5 x 5, three 3 x 3) with three
    3 x 3 stride-2 max pools, then with ``num_classes > 0`` three
    ``Linear`` layers, the first two after dropout."""

    def __init__(self, num_classes=1000, *, device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **m), ReLU(), MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, **m), ReLU(), MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, **m), ReLU(),
            Conv2D(384, 256, 3, padding=1, **m), ReLU(),
            Conv2D(256, 256, 3, padding=1, **m), ReLU(), MaxPool2D(3, 2))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(), Linear(256 * 6 * 6, 4096, **m), ReLU(),
                Dropout(), Linear(4096, 4096, **m), ReLU(),
                Linear(4096, num_classes, **m))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def alexnet(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return AlexNet(**kwargs)
