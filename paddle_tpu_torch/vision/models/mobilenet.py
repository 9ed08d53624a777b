"""MobileNet V1, V2 and V3 (large and small) of the port
(``paddle_tpu/vision/models/mobilenet.py``), with ``scale`` and the
reference's module names. The depthwise convolutions are grouped ones with
``groups`` = channels."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import functional as F
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Hardswish, Linear, ReLU,
                         ReLU6)
from ._common import made, refuse_pretrained


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    """Convolution (no bias, "same" padding), batch norm and ``act`` (none
    if None)."""

    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, act=ReLU, *, device=None,
                 generator=None):
        layers = [Conv2D(in_c, out_c, kernel, stride=stride, padding=(kernel - 1) // 2,
                         groups=groups, bias_attr=False, device=device, generator=generator),
                  BatchNorm2D(out_c, device=device)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_c, out_c, stride, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.dw = ConvBNReLU(in_c, in_c, 3, stride=stride, groups=in_c, **m)
        self.pw = ConvBNReLU(in_c, out_c, 1, **m)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    """A 3 x 3 stride-2 stem and 13 depthwise-separable blocks, widths times
    ``scale``; with ``with_pool`` a global average pool, with
    ``num_classes > 0`` a ``Linear`` head."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *, device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool

        def s(c):
            return int(c * scale)

        cfg = ([(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + [(512, 1)] * 5
               + [(1024, 2), (1024, 1)])
        layers, in_c = [ConvBNReLU(3, s(32), 3, stride=2, **m)], s(32)
        for c, st in cfg:
            layers.append(DepthwiseSeparable(in_c, s(c), st, **m))
            in_c = s(c)
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes, **m)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(nn.Module):
    """1 x 1 expansion (ReLU6), 3 x 3 depthwise (ReLU6), 1 x 1 linear
    projection, with a residual where the shape allows."""

    def __init__(self, in_c, out_c, stride, expand_ratio, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(in_c, hidden, 1, act=ReLU6, **m))
        layers += [ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden, act=ReLU6, **m),
                   Conv2D(hidden, out_c, 1, bias_attr=False, **m), BatchNorm2D(out_c, device=device)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *, device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
               (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        layers = [ConvBNReLU(3, in_c, 3, stride=2, act=ReLU6, **m)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                layers.append(InvertedResidual(in_c, out_c, s if i == 0 else 1, t, **m))
                in_c = out_c
        layers.append(ConvBNReLU(in_c, last_c, 1, act=ReLU6, **m))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(Dropout(0.2), Linear(last_c, num_classes, **m))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


class SqueezeExcite(nn.Module):
    """Channel weights from a global average pool, two 1 x 1 convolutions
    (ReLU, then the reference's hard sigmoid)."""

    def __init__(self, ch, squeeze=4, *, device=None, generator=None):
        super().__init__()
        mid = _make_divisible(ch // squeeze)
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(ch, mid, 1, device=device, generator=generator)
        self.fc2 = Conv2D(mid, ch, 1, device=device, generator=generator)

    def forward(self, x):
        s = F.relu(self.fc1(self.pool(x)))
        return x * F.hardsigmoid(self.fc2(s))


class V3Block(nn.Module):
    def __init__(self, in_c, mid_c, out_c, kernel, stride, use_se, act, *, device=None,
                 generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if mid_c != in_c:
            layers.append(ConvBNReLU(in_c, mid_c, 1, act=act, **m))
        layers.append(ConvBNReLU(mid_c, mid_c, kernel, stride=stride, groups=mid_c, act=act, **m))
        if use_se:
            layers.append(SqueezeExcite(mid_c, **m))
        layers += [Conv2D(mid_c, out_c, 1, bias_attr=False, **m), BatchNorm2D(out_c, device=device)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


_V3_LARGE = [
    # kernel, expansion, out, squeeze-excite, activation, stride
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2), (3, 72, 24, False, ReLU, 1),
    (5, 72, 40, True, ReLU, 2), (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]
_V3_SMALL = [
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2), (3, 88, 24, False, ReLU, 1),
    (5, 96, 40, True, Hardswish, 2), (5, 240, 40, True, Hardswish, 1),
    (5, 240, 40, True, Hardswish, 1), (5, 120, 48, True, Hardswish, 1),
    (5, 144, 48, True, Hardswish, 1), (5, 288, 96, True, Hardswish, 2),
    (5, 576, 96, True, Hardswish, 1), (5, 576, 96, True, Hardswish, 1),
]


class MobileNetV3(nn.Module):
    """A hard-swish stem, the ``cfg`` blocks, a 1 x 1 convolution to the last
    block's expansion, then with ``num_classes > 0`` ``Linear`` to
    ``last_c``, hard swish, dropout and ``Linear`` to the classes."""

    def __init__(self, cfg, last_c, scale=1.0, num_classes=1000, with_pool=True, *, device=None,
                 seed=0):
        super().__init__()
        m = made(device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        in_c = _make_divisible(16 * scale)
        layers = [ConvBNReLU(3, in_c, 3, stride=2, act=Hardswish, **m)]
        for k, exp, out, se, act, s in cfg:
            out_c = _make_divisible(out * scale)
            layers.append(V3Block(in_c, _make_divisible(exp * scale), out_c, k, s, se, act, **m))
            in_c = out_c
        final_mid = _make_divisible(cfg[-1][1] * scale)
        layers.append(ConvBNReLU(in_c, final_mid, 1, act=Hardswish, **m))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(Linear(final_mid, last_c, **m), Hardswish(),
                                            Dropout(0.2), Linear(last_c, num_classes, **m))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV3(_V3_LARGE, 1280, scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV3(_V3_SMALL, 1024, scale=scale, **kwargs)
