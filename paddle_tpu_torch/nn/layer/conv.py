"""Convolution layers of the port (``paddle_tpu/nn/layer/conv.py``):
``Conv1D/2D/3D`` and ``Conv1DTranspose/2DTranspose/3DTranspose``."""
from __future__ import annotations

import math

from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from ._attr import param, wants


class _ConvNd(nn.Module):
    """``weight`` ``[out, in / groups, *kernel]`` (a transposed one's ``[in,
    out / groups, *kernel]``) drawn Normal(0, sqrt(2 / fan_in)), fan_in =
    ``in / groups`` times the kernel's size, and a zero ``bias`` (none with
    ``bias_attr=False``), as the reference's ``_ConvNd`` makes them.
    ``padding_mode`` other than ``"zeros"`` is not ported (the reference
    ignores it)."""

    _n = 2
    _format = "NCHW"
    _transposed = False

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
        shape = ([in_channels, out_channels // groups, *ks] if self._transposed
                 else [out_channels, in_channels // groups, *ks])
        std = math.sqrt(2.0 / (in_channels // groups * math.prod(ks)))
        self.weight = param(shape, weight_attr, lambda shape, dtype, g, d: I.normal(shape, std, g, d),
                            generator, device, layer=name)
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


class _ConvTranspose(_ConvNd):
    _transposed = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format=None, *, device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format, device=device,
                         generator=generator)
        self.output_padding = output_padding

    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self.stride, self.padding, self.output_padding,
                        self.dilation, self.groups, output_size, self.data_format)


class Conv1DTranspose(_ConvTranspose):
    _n, _format = 1, "NCL"
    _fn = staticmethod(F.conv1d_transpose)


class Conv2DTranspose(_ConvTranspose):
    _n, _format = 2, "NCHW"
    _fn = staticmethod(F.conv2d_transpose)


class Conv3DTranspose(_ConvTranspose):
    _n, _format = 3, "NCDHW"
    _fn = staticmethod(F.conv3d_transpose)
