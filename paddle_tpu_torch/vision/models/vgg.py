"""VGG of the port (``paddle_tpu/vision/models/vgg.py``): ``vgg11``,
``vgg13``, ``vgg16`` and ``vgg19``, each with or without batch norms, with
the reference's module names."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear, MaxPool2D, ReLU
from ._common import made, refuse_pretrained

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512,
          512, 512, "M"],
}


def _make_features(cfg, batch_norm, m):
    layers, in_c = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
            continue
        layers.append(Conv2D(in_c, v, 3, padding=1, **m))
        if batch_norm:
            layers.append(BatchNorm2D(v, device=m["device"]))
        layers.append(ReLU())
        in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Module):
    """``features``, then with ``with_pool`` a 7 x 7 adaptive average pool
    and with ``num_classes > 0`` three ``Linear`` layers with dropout. The
    head's weights come from ``generator`` (the features' own, through the
    constructors), else one seeded ``seed``."""

    def __init__(self, features, num_classes=1000, with_pool=True, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        m = made(device, seed, generator)
        self.features = features
        self.num_classes, self.with_pool = num_classes, with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Linear(512 * 7 * 7, 4096, **m), ReLU(), Dropout(),
                Linear(4096, 4096, **m), ReLU(), Dropout(),
                Linear(4096, num_classes, **m))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, pretrained, batch_norm, device=None, seed=0, **kwargs):
    refuse_pretrained(pretrained)
    m = made(device, seed)
    return VGG(_make_features(_CFGS[cfg], batch_norm, m), **kwargs, **m)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", pretrained, batch_norm, **kwargs)
