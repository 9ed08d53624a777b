"""GoogLeNet (Inception v1) of the port (``paddle_tpu/vision/models/googlenet.py``),
with the reference's module names (batch norms after each convolution,
no auxiliary heads)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear, MaxPool2D, ReLU
from ._common import made, refuse_pretrained


class ConvBN(nn.Module):
    """Convolution (no bias), batch norm, ReLU."""

    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, *, device=None, generator=None):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, kernel, stride=stride, padding=padding, bias_attr=False,
                           device=device, generator=generator)
        self.bn = BatchNorm2D(out_c, device=device)
        self.relu = ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class Inception(nn.Module):
    """1 x 1; 1 x 1 then 3 x 3; 1 x 1 then 5 x 5; 3 x 3 max pool then 1 x 1;
    joined on the channels."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.b1 = ConvBN(in_c, c1, 1, **m)
        self.b2 = nn.Sequential(ConvBN(in_c, c3r, 1, **m), ConvBN(c3r, c3, 3, padding=1, **m))
        self.b3 = nn.Sequential(ConvBN(in_c, c5r, 1, **m), ConvBN(c5r, c5, 5, padding=2, **m))
        self.b4 = nn.Sequential(MaxPool2D(3, stride=1, padding=1), ConvBN(in_c, proj, 1, **m))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], 1)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        self.stem = nn.Sequential(ConvBN(3, 64, 7, stride=2, padding=3, **m),
                                  MaxPool2D(3, stride=2, padding=1), ConvBN(64, 64, 1, **m),
                                  ConvBN(64, 192, 3, padding=1, **m),
                                  MaxPool2D(3, stride=2, padding=1))
        self.ince3a = Inception(192, 64, 96, 128, 16, 32, 32, **m)
        self.ince3b = Inception(256, 128, 128, 192, 32, 96, 64, **m)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.ince4a = Inception(480, 192, 96, 208, 16, 48, 64, **m)
        self.ince4b = Inception(512, 160, 112, 224, 24, 64, 64, **m)
        self.ince4c = Inception(512, 128, 128, 256, 24, 64, 64, **m)
        self.ince4d = Inception(512, 112, 144, 288, 32, 64, 64, **m)
        self.ince4e = Inception(528, 256, 160, 320, 32, 128, 128, **m)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.ince5a = Inception(832, 256, 160, 320, 32, 128, 128, **m)
        self.ince5b = Inception(832, 384, 192, 384, 48, 128, 128, **m)
        if with_pool:
            self.pool5 = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.4)
            self.fc = Linear(1024, num_classes, **m)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.ince3b(self.ince3a(x)))
        x = self.pool4(self.ince4e(self.ince4d(self.ince4c(self.ince4b(self.ince4a(x))))))
        x = self.ince5b(self.ince5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(torch.flatten(x, 1)))
        return x


def googlenet(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return GoogLeNet(**kwargs)
