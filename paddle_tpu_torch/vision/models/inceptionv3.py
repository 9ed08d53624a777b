"""Inception v3 of the port (``paddle_tpu/vision/models/inceptionv3.py``),
with the reference's module names (no auxiliary head); its published input
is 299 x 299."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import AdaptiveAvgPool2D, AvgPool2D, Dropout, Linear, MaxPool2D
from ._common import made, refuse_pretrained
from .googlenet import ConvBN


class InceptionA(nn.Module):
    def __init__(self, in_c, pool_c, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.b1 = ConvBN(in_c, 64, 1, **m)
        self.b5 = nn.Sequential(ConvBN(in_c, 48, 1, **m), ConvBN(48, 64, 5, padding=2, **m))
        self.b3 = nn.Sequential(ConvBN(in_c, 64, 1, **m), ConvBN(64, 96, 3, padding=1, **m),
                                ConvBN(96, 96, 3, padding=1, **m))
        self.bp = nn.Sequential(AvgPool2D(3, stride=1, padding=1), ConvBN(in_c, pool_c, 1, **m))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], 1)


class ReductionA(nn.Module):
    def __init__(self, in_c, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.b3 = ConvBN(in_c, 384, 3, stride=2, **m)
        self.b3d = nn.Sequential(ConvBN(in_c, 64, 1, **m), ConvBN(64, 96, 3, padding=1, **m),
                                 ConvBN(96, 96, 3, stride=2, **m))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], 1)


class InceptionB(nn.Module):
    def __init__(self, in_c, c7, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.b1 = ConvBN(in_c, 192, 1, **m)
        self.b7 = nn.Sequential(ConvBN(in_c, c7, 1, **m), ConvBN(c7, c7, (1, 7), padding=(0, 3), **m),
                                ConvBN(c7, 192, (7, 1), padding=(3, 0), **m))
        self.b7d = nn.Sequential(
            ConvBN(in_c, c7, 1, **m),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **m), ConvBN(c7, c7, (1, 7), padding=(0, 3), **m),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **m), ConvBN(c7, 192, (1, 7), padding=(0, 3), **m))
        self.bp = nn.Sequential(AvgPool2D(3, stride=1, padding=1), ConvBN(in_c, 192, 1, **m))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], 1)


class ReductionB(nn.Module):
    def __init__(self, in_c, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.b3 = nn.Sequential(ConvBN(in_c, 192, 1, **m), ConvBN(192, 320, 3, stride=2, **m))
        self.b7 = nn.Sequential(
            ConvBN(in_c, 192, 1, **m), ConvBN(192, 192, (1, 7), padding=(0, 3), **m),
            ConvBN(192, 192, (7, 1), padding=(3, 0), **m), ConvBN(192, 192, 3, stride=2, **m))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_c, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.b1 = ConvBN(in_c, 320, 1, **m)
        self.b3_stem = ConvBN(in_c, 384, 1, **m)
        self.b3_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **m)
        self.b3_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **m)
        self.b3d_stem = nn.Sequential(ConvBN(in_c, 448, 1, **m), ConvBN(448, 384, 3, padding=1, **m))
        self.b3d_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **m)
        self.b3d_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **m)
        self.bp = nn.Sequential(AvgPool2D(3, stride=1, padding=1), ConvBN(in_c, 192, 1, **m))

    def forward(self, x):
        s, d = self.b3_stem(x), self.b3d_stem(x)
        return torch.cat([self.b1(x), self.b3_a(s), self.b3_b(s), self.b3d_a(d), self.b3d_b(d),
                          self.bp(x)], 1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        self.stem = nn.Sequential(
            ConvBN(3, 32, 3, stride=2, **m), ConvBN(32, 32, 3, **m), ConvBN(32, 64, 3, padding=1, **m),
            MaxPool2D(3, stride=2), ConvBN(64, 80, 1, **m), ConvBN(80, 192, 3, **m),
            MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            InceptionA(192, 32, **m), InceptionA(256, 64, **m), InceptionA(288, 64, **m),
            ReductionA(288, **m),
            InceptionB(768, 128, **m), InceptionB(768, 160, **m), InceptionB(768, 160, **m),
            InceptionB(768, 192, **m),
            ReductionB(768, **m),
            InceptionC(1280, **m), InceptionC(2048, **m))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.5)
            self.fc = Linear(2048, num_classes, **m)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(torch.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return InceptionV3(**kwargs)
