"""Convolution layers of the port (``paddle_tpu/nn/layer/conv.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from ._attr import param, wants


class _ConvNd(nn.Module):
    """``weight`` ``[out, in / groups, *kernel]`` drawn Normal(0, sqrt(2 /
    fan_in)) and a zero ``bias`` (none with ``bias_attr=False``).
    ``padding_mode`` other than ``"zeros"`` is not ported (the reference
    ignores it)."""

    _n = 2
    _format = "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None, data_format=None,
                 *, device=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r} is not ported, only 'zeros'")
        device = resolve_device(device)
        n = self._n
        ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) else [kernel_size] * n
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = ks, stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format or self._format
        name = type(self).__name__
        self.weight = param([out_channels, in_channels // groups, *ks], weight_attr,
                            lambda shape, dtype, g, d: I.conv_normal(shape, g, d), generator,
                            device, layer=name)
        self.bias = (param((out_channels,), bias_attr, I.Constant(0.0), generator, device,
                           is_bias=True, layer=name, what="bias")
                     if wants(bias_attr, name, "bias") else None)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, padding={self.padding}, bias={self.bias is not None}")


class Conv1D(_ConvNd):
    _n, _format = 1, "NCL"

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups, self.data_format)


class Conv2D(_ConvNd):
    _n, _format = 2, "NCHW"

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups, self.data_format)


class Conv3D(_ConvNd):
    _n, _format = 3, "NCDHW"

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups, self.data_format)
