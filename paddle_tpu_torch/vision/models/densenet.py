"""DenseNet of the port (``paddle_tpu/vision/models/densenet.py``): 121,
161, 169, 201 and 264 layers, with the reference's module names."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                         MaxPool2D, ReLU)
from ._common import made, refuse_pretrained

_CFGS = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class DenseLayer(nn.Module):
    """BN-ReLU-1 x 1 conv to ``bn_size * growth_rate``, BN-ReLU-3 x 3 conv to
    ``growth_rate`` (then dropout if any), joined after the input."""

    def __init__(self, in_c, growth_rate, bn_size, dropout, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.norm1 = BatchNorm2D(in_c, device=device)
        self.conv1 = Conv2D(in_c, bn_size * growth_rate, 1, bias_attr=False, **m)
        self.norm2 = BatchNorm2D(bn_size * growth_rate, device=device)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1, bias_attr=False, **m)
        self.relu = ReLU()
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], 1)


class Transition(nn.Module):
    def __init__(self, in_c, out_c, *, device=None, generator=None):
        super().__init__()
        self.norm = BatchNorm2D(in_c, device=device)
        self.conv = Conv2D(in_c, out_c, 1, bias_attr=False, device=device, generator=generator)
        self.relu = ReLU()
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(nn.Module):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000, with_pool=True, *,
                 device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        init_c, growth, blocks = _CFGS[layers]
        self.num_classes, self.with_pool = num_classes, with_pool
        self.stem = nn.Sequential(Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False, **m),
                                  BatchNorm2D(init_c, device=m["device"]), ReLU(),
                                  MaxPool2D(3, stride=2, padding=1))
        ch, feats = init_c, []
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(DenseLayer(ch, growth, bn_size, dropout, **m))
                ch += growth
            if i != len(blocks) - 1:
                feats.append(Transition(ch, ch // 2, **m))
                ch //= 2
        feats += [BatchNorm2D(ch, device=m["device"]), ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Linear(ch, num_classes, **m)

    def forward(self, x):
        x = self.features(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _densenet(layers, pretrained, **kwargs):
    refuse_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
