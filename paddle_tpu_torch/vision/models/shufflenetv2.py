"""ShuffleNet V2 of the port (``paddle_tpu/vision/models/shufflenetv2.py``):
x0.5, x1.0, x1.5 and x2.0, with the reference's module names.

A stride-2 unit's first branch ends in ``out / 2`` channels, as in Paddle.
The reference's ends in ``in`` channels, so its x1.0, x1.5 and x2.0 fail
at their first stride-1 unit (ROADMAP.md, "Faults in the reference"); at
x0.5, where ``in = out / 2``, the two are the same network."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU
from ._common import made, refuse_pretrained

_CFGS = {
    "0.5": ([4, 8, 4], [24, 48, 96, 192, 1024]),
    "1.0": ([4, 8, 4], [24, 116, 232, 464, 1024]),
    "1.5": ([4, 8, 4], [24, 176, 352, 704, 1024]),
    "2.0": ([4, 8, 4], [24, 244, 488, 976, 2048]),
}


def channel_shuffle(x, groups):
    """``[b, c, h, w]`` with its channels read as ``[groups, c / groups]``
    and transposed."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _dw_bn(in_c, out_c, kernel, stride, m):
    return nn.Sequential(
        Conv2D(in_c, in_c, kernel, stride=stride, padding=kernel // 2, groups=in_c,
               bias_attr=False, **m),
        BatchNorm2D(in_c, device=m["device"]),
        Conv2D(in_c, out_c, 1, bias_attr=False, **m), BatchNorm2D(out_c, device=m["device"]),
        ReLU())


def _pw_bn_relu(in_c, out_c, m):
    return nn.Sequential(Conv2D(in_c, out_c, 1, bias_attr=False, **m),
                         BatchNorm2D(out_c, device=m["device"]), ReLU())


class ShuffleUnit(nn.Module):
    """Stride 1: half the channels through a pointwise and a depthwise
    branch, the other half as they are; stride 2: both through a branch.
    Joined on the channels and shuffled in 2 groups."""

    def __init__(self, in_c, out_c, stride, *, device=None, generator=None):
        super().__init__()
        m = dict(device=device, generator=generator)
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(_pw_bn_relu(in_c // 2, branch_c, m),
                                         _dw_bn(branch_c, branch_c, 3, 1, m))
        else:
            # to out_c / 2, as Paddle's; the reference's goes to in_c, which
            # matches only where in_c = out_c / 2 (x0.5)
            self.branch1 = _dw_bn(in_c, branch_c, 3, stride, m)
            self.branch2 = nn.Sequential(_pw_bn_relu(in_c, branch_c, m),
                                         _dw_bn(branch_c, branch_c, 3, stride, m))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = torch.cat([x[:, :c], self.branch2(x[:, c:])], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    def __init__(self, scale="1.0", num_classes=1000, with_pool=True, *, device=None, seed=0):
        super().__init__()
        m = made(device, seed)
        stages, chans = _CFGS[str(scale)]
        self.num_classes, self.with_pool = num_classes, with_pool
        self.conv1 = nn.Sequential(Conv2D(3, chans[0], 3, stride=2, padding=1, bias_attr=False, **m),
                                   BatchNorm2D(chans[0], device=m["device"]), ReLU())
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        blocks, in_c = [], chans[0]
        for i, reps in enumerate(stages):
            out_c = chans[i + 1]
            blocks.append(ShuffleUnit(in_c, out_c, 2, **m))
            blocks += [ShuffleUnit(out_c, out_c, 1, **m) for _ in range(reps - 1)]
            in_c = out_c
        self.features = nn.Sequential(*blocks)
        self.conv_last = _pw_bn_relu(in_c, chans[-1], m)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(chans[-1], num_classes, **m)

    def forward(self, x):
        x = self.conv_last(self.features(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _shufflenet(scale, pretrained, **kwargs):
    refuse_pretrained(pretrained)
    return ShuffleNetV2(scale, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet("0.5", pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet("1.0", pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet("1.5", pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet("2.0", pretrained, **kwargs)
