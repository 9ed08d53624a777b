"""Common layers of the port (``paddle_tpu/nn/layer/common.py``): ``Linear``,
``Embedding``, ``Identity``, the dropouts, ``Flatten``, the upsamplers,
``Bilinear``, the pads, ``CosineSimilarity`` and ``Unfold``.

A layer with weights draws them from ``generator`` (None: the current
random stream) on ``device`` (None: the CUDA card), and takes a
``ParamAttr`` for each (``nn/layer/_attr.py``). The dropout layers
draw their masks from the current stream.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.selected_rows import in_compiled_step, record_rows
from .. import functional as F
from .. import initializer as I
from ..functional import common as _common
from ._attr import param


class Linear(nn.Module):
    """``paddle.nn.Linear``: ``x @ weight + bias`` with the reference's
    ``[in, out]`` weight, drawn XavierNormal, and a zero bias (none with
    ``bias_attr=False``). ``weight_attr``/``bias_attr``: a parameter
    attribute whose ``initializer`` replaces the default, as in the
    reference."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = param((in_features, out_features), weight_attr, I.XavierNormal(), generator,
                            device, layer="Linear")
        self.bias = None
        if bias_attr is not False:
            self.bias = param((out_features,), bias_attr, I.Constant(0.0), generator, device,
                              is_bias=True, layer="Linear", what="bias")

    def forward(self, x):
        return _common.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """``paddle.nn.Embedding``: a ``[num_embeddings, embedding_dim]`` table
    drawn Normal(0, ``init_std``), where ``init_std`` is 1 as in the
    reference, looked up by :func:`~paddle_tpu_torch.nn.functional.embedding`
    (an out-of-range id raises outside a ``TrainStep`` and gives the zero row
    inside one; ``padding_idx`` rows give zeros and get no gradient).
    ``sparse=True`` records the rows each gradient-taking forward outside a
    ``TrainStep`` looks up, for the lazy eager optimizers (``SGD``,
    ``Adam(lazy_mode=True)``)."""

    init_std = 1.0

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        self._sparse = bool(sparse)
        std = self.init_std
        self.weight = param((num_embeddings, embedding_dim), weight_attr,
                            lambda shape, dtype, g, d: I.normal(shape, std, g, d), generator,
                            device, layer=type(self).__name__)

    def forward(self, x):
        out = _common.embedding(x, self.weight, padding_idx=self.padding_idx)
        if (self._sparse and self.weight.requires_grad and torch.is_grad_enabled()
                and not in_compiled_step()):
            record_rows(self.weight, x)
        return out

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout(nn.Module):
    """``paddle.nn.Dropout``: :func:`~paddle_tpu_torch.nn.functional.dropout`
    with the module's training flag."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training, data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training, data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.data_format = align_corners, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode, self.align_corners,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, data_format)


class Bilinear(nn.Module):
    """``out = x1 W x2 + b`` with W ``[out, in1, in2]`` drawn
    Uniform(+-1/sqrt(in1)) and a zero bias."""

    def __init__(self, in1_features, in2_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        bound = 1 / math.sqrt(in1_features)
        self.weight = param((out_features, in1_features, in2_features), weight_attr,
                            I.Uniform(-bound, bound), generator, device, layer="Bilinear")
        self.bias = None
        if bias_attr is not False:
            self.bias = param((out_features,), bias_attr, I.Constant(0.0), generator, device,
                              is_bias=True, layer="Bilinear", what="bias")

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _PadNd(nn.Module):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW"):
        super().__init__()
        self.padding, self.mode, self.value, self.data_format = padding, mode, value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings, self.dilations)
