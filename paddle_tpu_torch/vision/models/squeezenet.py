"""SqueezeNet 1.0 and 1.1 of the port (``paddle_tpu/vision/models/squeezenet.py``),
with the reference's module names."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import AdaptiveAvgPool2D, Conv2D, Dropout, MaxPool2D, ReLU
from ._common import made, refuse_pretrained


class Fire(nn.Module):
    """A 1 x 1 squeeze, then 1 x 1 and 3 x 3 expands joined on the
    channels, each after a ReLU."""

    def __init__(self, in_c, squeeze_c, e1_c, e3_c, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.squeeze = Conv2D(in_c, squeeze_c, 1, **m)
        self.expand1 = Conv2D(squeeze_c, e1_c, 1, **m)
        self.expand3 = Conv2D(squeeze_c, e3_c, 3, padding=1, **m)
        self.relu = ReLU()

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(s)), self.relu(self.expand3(s))], 1)


class SqueezeNet(nn.Module):
    """``version`` "1.0" (7 x 7 stem, 96 channels) or "1.1" (3 x 3, 64),
    eight ``Fire`` modules between 3 x 3 stride-2 max pools, and with
    ``num_classes > 0`` a dropout, a 1 x 1 convolution to the classes, a
    ReLU and a global average pool. ``with_pool`` is kept and not read, as
    in the reference."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *, device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                Conv2D(3, 96, 7, stride=2, **m), ReLU(), MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64, **m), Fire(128, 16, 64, 64, **m),
                Fire(128, 32, 128, 128, **m), MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128, **m), Fire(256, 48, 192, 192, **m),
                Fire(384, 48, 192, 192, **m), Fire(384, 64, 256, 256, **m),
                MaxPool2D(3, stride=2), Fire(512, 64, 256, 256, **m))
        else:
            self.features = nn.Sequential(
                Conv2D(3, 64, 3, stride=2, **m), ReLU(), MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64, **m), Fire(128, 16, 64, 64, **m), MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128, **m), Fire(256, 32, 128, 128, **m),
                MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192, **m), Fire(384, 48, 192, 192, **m),
                Fire(384, 64, 256, 256, **m), Fire(512, 64, 256, 256, **m))
        if num_classes > 0:
            self.classifier = nn.Sequential(Dropout(0.5), Conv2D(512, num_classes, 1, **m), ReLU(),
                                            AdaptiveAvgPool2D(1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = torch.flatten(self.classifier(x), 1)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
