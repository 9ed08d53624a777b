"""The normalisation layers of the port (``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``, the batch norms, ``GroupNorm``, the instance norms,
``LocalResponseNorm``, ``RMSNorm`` and ``SpectralNorm`` (which raises, as
the reference's does)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from ._attr import param, wants


def _affine(layer, num, weight_attr, bias_attr, device):
    """A norm's per-channel ``weight`` (ones) and ``bias`` (zeros), each
    None with its attribute False."""
    name = type(layer).__name__
    layer.weight = (param((num,), weight_attr, I.Constant(1.0), None, device, layer=name)
                    if wants(weight_attr, name, "weight") else None)
    layer.bias = (param((num,), bias_attr, I.Constant(0.0), None, device, is_bias=True,
                        layer=name, what="bias") if wants(bias_attr, name, "bias") else None)


class LayerNorm(nn.Module):
    """``paddle.nn.LayerNorm`` over the last ``len(normalized_shape)`` dims:
    weight ones, bias zeros (none with ``weight_attr``/``bias_attr`` False),
    ``epsilon`` 1e-5; over the last dim with both, through the fused
    LayerNorm with its closed-form backward
    (:func:`~paddle_tpu_torch.nn.functional.layer_norm`)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None, name=None,
                 *, device=None):
        super().__init__()
        device = resolve_device(device)
        shape = normalized_shape if isinstance(normalized_shape, (list, tuple)) else [normalized_shape]
        self.normalized_shape = [int(d) for d in shape]
        self.epsilon = epsilon
        name = type(self).__name__
        self.weight = (param(self.normalized_shape, weight_attr, I.Constant(1.0), None, device,
                             layer=name) if wants(weight_attr, name, "weight") else None)
        self.bias = (param(self.normalized_shape, bias_attr, I.Constant(0.0), None, device,
                           is_bias=True, layer=name, what="bias")
                     if wants(bias_attr, name, "bias") else None)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"


class _BatchNormBase(nn.Module):
    """Batch norm over the channels (dim 1, or the last dim for a
    channel-last ``data_format``) with Paddle's semantics
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
        _affine(self, num_features, weight_attr, bias_attr, device)
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


class GroupNorm(nn.Module):
    """``paddle.nn.GroupNorm``: :func:`~paddle_tpu_torch.nn.functional.group_norm`
    with a per-channel ``weight`` (ones) and ``bias`` (zeros)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 data_format="NCHW", name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_groups, self.num_channels, self.epsilon = num_groups, num_channels, epsilon
        self.data_format = data_format
        _affine(self, num_channels, weight_attr, bias_attr, device)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight, self.bias,
                            self.data_format)

    def extra_repr(self):
        return f"num_groups={self.num_groups}, num_channels={self.num_channels}"


class _InstanceNormBase(nn.Module):
    """Instance norm (:func:`~paddle_tpu_torch.nn.functional.instance_norm`)
    over each sample's channels, with a per-channel ``weight`` (ones) and
    ``bias`` (zeros); no running statistics. ``data_format`` is honoured
    (the reference's layers drop it)."""

    _format = "NCHW"

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None, bias_attr=None,
                 data_format=None, name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_features, self.epsilon, self.momentum = num_features, epsilon, momentum
        self.data_format = data_format or self._format
        _affine(self, num_features, weight_attr, bias_attr, device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self.epsilon,
                               data_format=self.data_format)

    def extra_repr(self):
        return f"{self.num_features}, epsilon={self.epsilon}, data_format={self.data_format}"


class InstanceNorm1D(_InstanceNormBase):
    _format = "NCL"


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    _format = "NCDHW"


class LocalResponseNorm(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.local_response_norm` as a layer."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta, self.k,
                                     self.data_format)


class RMSNorm(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.rms_norm` over the last dim
    with a ``weight`` of ones."""

    def __init__(self, hidden_size, epsilon=1e-6, name=None, *, weight_attr=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.weight = param((hidden_size,), weight_attr, I.Constant(1.0), None, device,
                            layer="RMSNorm")

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class SpectralNorm(nn.Module):
    """Not ported: the reference's raises at construction, and so does the
    port's (ROADMAP.md, "Faults in the reference")."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12, name=None):
        super().__init__()
        raise NotImplementedError("SpectralNorm is not implemented in the reference "
                                  "(paddle_tpu/nn/layer/norm.py), so the port has none")
