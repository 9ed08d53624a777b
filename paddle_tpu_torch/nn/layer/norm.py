"""``LayerNorm`` and the batch norms of the port (``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...ops.layer_norm import layer_norm_fused
from .. import functional as F
from ._attr import wants


class LayerNorm(nn.Module):
    """``paddle.nn.LayerNorm`` over the last dim: weight ones, bias zeros,
    ``epsilon`` 1e-5, through the fused LayerNorm with its closed-form
    backward."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None):
        super().__init__()
        device = resolve_device(device)
        shape = normalized_shape if isinstance(normalized_shape, (list, tuple)) else [normalized_shape]
        if len(shape) != 1:
            raise NotImplementedError("LayerNorm over more than the last dim is not ported yet")
        self.normalized_shape = list(shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(shape, device=device))

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
    by name. ``SyncBatchNorm`` waits for distributed training (ROADMAP.md,
    Queue 1 item 13)."""

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
        self.weight = (nn.Parameter(torch.ones(num_features, device=device))
                       if wants(weight_attr, name, "weight") else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, device=device))
                     if wants(bias_attr, name, "bias") else None)
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
