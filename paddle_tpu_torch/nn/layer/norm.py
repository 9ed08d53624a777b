"""``LayerNorm`` and the batch norms of the port (``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...ops.layer_norm import layer_norm_fused
from .. import functional as F
from .. import initializer as I
from ._attr import param, wants


class LayerNorm(nn.Module):
    """``paddle.nn.LayerNorm`` over the last dim: weight ones, bias zeros,
    ``epsilon`` 1e-5, through the fused LayerNorm with its closed-form
    backward."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None, name=None,
                 *, device=None):
        super().__init__()
        device = resolve_device(device)
        shape = normalized_shape if isinstance(normalized_shape, (list, tuple)) else [normalized_shape]
        if len(shape) != 1:
            raise NotImplementedError("LayerNorm over more than the last dim is not ported yet")
        self.normalized_shape = list(shape)
        self.epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            raise NotImplementedError("LayerNorm without its weight or bias is not ported yet")
        self.weight = param(shape, weight_attr, I.Constant(1.0), None, device, layer="LayerNorm")
        self.bias = param(shape, bias_attr, I.Constant(0.0), None, device, is_bias=True,
                          layer="LayerNorm", what="bias")

    def forward(self, x):
        return layer_norm_fused(x, self.weight, self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"


class _BatchNormBase(nn.Module):
    """Batch norm over the channels (dim 1) with Paddle's semantics
    (:func:`paddle_tpu_torch.nn.functional.batch_norm`): ``weight`` ones,
    ``bias`` zeros (none with ``weight_attr``/``bias_attr`` False), and the
    running statistics in the f32 buffers ``_mean`` (zeros) and
    ``_variance`` (ones), the reference's names, so a state carries across
    by name."""

    # the 1-D and 3-D layers keep their layout whatever is passed, as the reference's do
    _format = None

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 data_format="NCHW", use_global_stats=None, name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_features, self.momentum, self.epsilon = num_features, momentum, epsilon
        self.data_format = self._format or data_format
        self.use_global_stats = use_global_stats
        name = type(self).__name__
        self.weight = (param((num_features,), weight_attr, I.Constant(1.0), None, device,
                             layer=name) if wants(weight_attr, name, "weight") else None)
        self.bias = (param((num_features,), bias_attr, I.Constant(0.0), None, device, is_bias=True,
                           layer=name, what="bias") if wants(bias_attr, name, "bias") else None)
        self.register_buffer("_mean", torch.zeros(num_features, device=device))
        self.register_buffer("_variance", torch.ones(num_features, device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format, use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"{self.num_features}, momentum={self.momentum}, epsilon={self.epsilon}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    _format = "NCL"


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    _format = "NCDHW"


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics are those of the whole batch
    across the data-parallel group
    (:func:`~paddle_tpu_torch.nn.functional.sync_batch_norm`): the
    reference's batch norm over a batch that GSPMD shards. With one rank it
    is :class:`BatchNorm2D`."""

    def forward(self, x):
        return F.sync_batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                                 training=self.training, momentum=self.momentum,
                                 epsilon=self.epsilon, data_format=self.data_format,
                                 use_global_stats=self.use_global_stats)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Swap every batch norm below ``layer`` for a ``SyncBatchNorm``
        sharing its weight, bias and buffers, in place (the reference's
        :79-90); returns ``layer``."""
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, _BatchNormBase) and not isinstance(sub, SyncBatchNorm):
                new = cls(sub.num_features, sub.momentum, sub.epsilon,
                          data_format=sub.data_format, use_global_stats=sub.use_global_stats,
                          device=sub._mean.device)
                new.weight, new.bias = sub.weight, sub.bias
                new._buffers = sub._buffers
                new.train(sub.training)
                layer._modules[name] = new
            elif sub is not None:
                cls.convert_sync_batchnorm(sub)
        return layer
