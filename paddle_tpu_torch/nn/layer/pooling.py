"""Pooling layers of the port (``paddle_tpu/nn/layer/pooling.py``), each its
functional (:mod:`paddle_tpu_torch.nn.functional.pooling`) with Paddle's
arguments."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class _Pool(nn.Module):
    """A pool layer: ``_fn`` called with the input and the layer's
    arguments (``_args``, in the functional's order)."""

    _fn = None
    _args = ()

    def forward(self, x):
        return self._fn(x, *(getattr(self, a) for a in self._args))

    def extra_repr(self):
        return ", ".join(f"{a}={getattr(self, a)!r}" for a in self._args)


class _MaxPool(_Pool):
    _args = ("kernel_size", "stride", "padding", "return_mask", "ceil_mode", "data_format")

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
                 data_format=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format or self._format


class MaxPool1D(_MaxPool):
    _args = _MaxPool._args[:-1]
    _fn = staticmethod(F.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask, ceil_mode, "NCL")


class MaxPool2D(_MaxPool):
    _fn, _format = staticmethod(F.max_pool2d), "NCHW"


class MaxPool3D(_MaxPool):
    _fn, _format = staticmethod(F.max_pool3d), "NCDHW"


class AvgPool1D(_Pool):
    _args = ("kernel_size", "stride", "padding", "exclusive", "ceil_mode")
    _fn = staticmethod(F.avg_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.exclusive, self.ceil_mode = exclusive, ceil_mode


class _AvgPool(_Pool):
    _args = ("kernel_size", "stride", "padding", "ceil_mode", "exclusive", "divisor_override",
             "data_format")

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
                 divisor_override=None, data_format=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override, self.data_format = divisor_override, data_format or self._format


class AvgPool2D(_AvgPool):
    _fn, _format = staticmethod(F.avg_pool2d), "NCHW"


class AvgPool3D(_AvgPool):
    _fn, _format = staticmethod(F.avg_pool3d), "NCDHW"


class _AdaptiveAvgPool(_Pool):
    _args = ("output_size", "data_format")

    def __init__(self, output_size, data_format=None, name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format or self._format


class AdaptiveAvgPool1D(_AdaptiveAvgPool):
    _args, _fn = ("output_size",), staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size, name=None):
        super().__init__(output_size, "NCL")


class AdaptiveAvgPool2D(_AdaptiveAvgPool):
    _fn, _format = staticmethod(F.adaptive_avg_pool2d), "NCHW"


class AdaptiveAvgPool3D(_AdaptiveAvgPool):
    _fn, _format = staticmethod(F.adaptive_avg_pool3d), "NCDHW"


class _AdaptiveMaxPool(_Pool):
    _args = ("output_size", "return_mask")

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask


class AdaptiveMaxPool1D(_AdaptiveMaxPool):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptiveMaxPool):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptiveMaxPool):
    _fn = staticmethod(F.adaptive_max_pool3d)
