"""``Linear`` and ``Embedding`` of the port (``paddle_tpu/nn/layer/common.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...framework.device import resolve_device
from .. import initializer as I


class Linear(nn.Module):
    """``paddle.nn.Linear``: ``x @ weight + bias`` with the reference's
    ``[in, out]`` weight, drawn XavierNormal, and a zero bias."""

    def __init__(self, in_features, out_features, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(I.xavier_normal((in_features, out_features), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return x @ self.weight + self.bias

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """``paddle.nn.Embedding``: a ``[num_embeddings, embedding_dim]`` table
    drawn Normal(0, ``init_std``), where ``init_std`` is 1 as in the
    reference. ``padding_idx`` and ``sparse`` are not ported."""

    init_std = 1.0

    def __init__(self, num_embeddings, embedding_dim, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.weight = nn.Parameter(
            I.normal((num_embeddings, embedding_dim), self.init_std, generator, device))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
