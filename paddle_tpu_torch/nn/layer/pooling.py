"""Pooling layers of the port (``paddle_tpu/nn/layer/pooling.py``); the
knobs the port does not take raise in the functionals."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
                 data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.return_mask, self.ceil_mode, self.data_format = return_mask, ceil_mode, data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding, self.return_mask,
                            self.ceil_mode, self.data_format)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
                 divisor_override=None, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override, self.data_format = divisor_override, data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding, self.ceil_mode,
                            self.exclusive, self.divisor_override, self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
