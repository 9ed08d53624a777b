"""The ResNet family of the port (``paddle_tpu/vision/models/resnet.py``):
``resnet18``-``152``, ``resnext*`` and ``wide_resnet*``, with the
reference's module names, so a state carries across by name.

NCHW as in the reference; the convolutions are cuDNN's through
``torch.nn.functional.conv2d`` and the batch norms ATen's, none a kernel of
this repository (the reference runs no Pallas kernel on this path).
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn.layer import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU


class BasicBlock(nn.Module):
    """Two 3 x 3 convolutions with batch norms and a residual. ``groups``
    and ``base_width`` are taken and ignored, as in the reference."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=dilation, dilation=dilation,
                            bias_attr=False, device=device, generator=generator)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False, device=device,
                            generator=generator)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    """1 x 1, 3 x 3 (carrying the stride and the groups) and 1 x 1
    convolutions with batch norms and a residual; the inner width is
    ``planes * base_width / 64 * groups``."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        conv = dict(bias_attr=False, device=device, generator=generator)
        self.conv1 = Conv2D(inplanes, width, 1, **conv)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation, groups=groups,
                            dilation=dilation, **conv)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, **conv)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


_LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
           152: [3, 8, 36, 3]}


class ResNet(nn.Module):
    """The stem (7 x 7 stride-2 convolution, batch norm, ReLU, 3 x 3
    stride-2 max pool), four stages of ``block``, then with ``with_pool``
    a global average pool and with ``num_classes > 0`` a ``Linear`` head.
    Random weights are drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (None: the card)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True, groups=1, *,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        made = dict(device=device, generator=torch.Generator(device=device).manual_seed(int(seed)))
        layers = _LAYERS[depth]
        self.groups, self.base_width = groups, width
        self.num_classes, self.with_pool = num_classes, with_pool
        self.inplanes = 64
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3, bias_attr=False, **made)
        self.bn1 = BatchNorm2D(self.inplanes, device=device)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, made)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, made)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, made)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, made)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **made)

    def _make_layer(self, block, planes, blocks, stride, made):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride, bias_attr=False,
                       **made),
                BatchNorm2D(planes * block.expansion, device=made["device"]))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups, self.base_width,
                        **made)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **made))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not available: the port downloads "
                                  "nothing; load a state with utils.convert instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=64, width=4, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)
