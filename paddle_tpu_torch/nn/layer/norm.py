"""``LayerNorm`` of the port (``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...ops.layer_norm import layer_norm_fused


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
