"""``Linear`` and ``Embedding`` of the port (``paddle_tpu/nn/layer/common.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.selected_rows import in_compiled_step, record_rows
from .. import initializer as I
from ..functional.common import embedding, linear


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
        return linear(x, self.weight, self.bias)

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

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        self._sparse = bool(sparse)
        self.weight = nn.Parameter(
            I.normal((num_embeddings, embedding_dim), self.init_std, generator, device))

    def forward(self, x):
        out = embedding(x, self.weight, padding_idx=self.padding_idx)
        if (self._sparse and self.weight.requires_grad and torch.is_grad_enabled()
                and not in_compiled_step()):
            record_rows(self.weight, x)
        return out

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
