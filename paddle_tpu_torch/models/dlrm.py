"""DLRM of the port (``paddle_tpu/models/dlrm.py``): a recommender over one
fused embedding table.

A dense bottom MLP, the sparse features' tables concatenated row-wise into
one :class:`~paddle_tpu_torch.distributed.embedding.ShardedEmbedding` (static
per-feature row offsets), the pairwise dot-product interaction, and a top
MLP ending in one logit. It trains through the ordinary ``TrainStep``, with
:class:`~paddle_tpu_torch.optimizer.RowSparseAdam` updating only the table
rows a step touched. The child names are the reference's (``bottom.0``,
``bottom.2``, ..., ``embedding.weight``, ``top.N``), so a state converts name
for name (:func:`paddle_tpu_torch.utils.convert.state_dict_by_name`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..distributed.embedding import ShardedEmbedding
from ..framework.device import resolve_device
from ..nn.layer import Linear, ReLU


class DLRMConfig:
    """``num_dense`` continuous features; one vocab size per sparse
    feature; the MLP tuples are hidden widths (the bottom MLP ends at
    ``embedding_dim``, the top one at 1)."""

    def __init__(self, num_dense=4, vocab_sizes=(64, 32, 128), embedding_dim=8,
                 bottom_mlp=(16,), top_mlp=(16,), axis="dp", capacity=None, pad_multiple=8):
        self.num_dense = int(num_dense)
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embedding_dim = int(embedding_dim)
        self.bottom_mlp = tuple(bottom_mlp)
        self.top_mlp = tuple(top_mlp)
        self.axis = axis
        self.capacity = capacity
        self.pad_multiple = int(pad_multiple)

    @property
    def num_sparse(self):
        return len(self.vocab_sizes)

    @property
    def total_vocab(self):
        return sum(self.vocab_sizes)

    @staticmethod
    def tiny():
        """CPU-test scale: 3 features, 224 fused rows, D = 8."""
        return DLRMConfig()


def _mlp(sizes, made):
    """``Linear`` + ``ReLU`` for each consecutive pair of ``sizes``."""
    return nn.Sequential(*[layer for i, o in zip(sizes[:-1], sizes[1:])
                           for layer in (Linear(i, o, **made), ReLU())])


class DLRM(nn.Module):
    """``forward(dense [B, num_dense] f32, ids [B, F] int) -> logits [B, 1]``.
    Random weights are drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (None: the card). ``mesh``: the fleet's grid (None: the
    active fleet's, if any); at a degree above 1 over ``config.axis`` the
    table is row-sharded over that axis, each rank holding its rows."""

    def __init__(self, config: DLRMConfig, mesh=None, *, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        made = dict(device=device, generator=torch.Generator(device=device).manual_seed(int(seed)))
        self.config = config
        d, f = config.embedding_dim, config.num_sparse
        self.bottom = _mlp((config.num_dense,) + config.bottom_mlp + (d,), made)
        self.embedding = ShardedEmbedding(config.total_vocab, d, axis=config.axis, mesh=mesh,
                                          capacity=config.capacity,
                                          pad_multiple=config.pad_multiple, **made)
        top_sizes = (d + (f + 1) * f // 2,) + config.top_mlp
        self.top = nn.Sequential(*_mlp(top_sizes, made), Linear(top_sizes[-1], 1, **made))
        # per-feature row offsets into the fused table, and the upper
        # triangle of the [F + 1, F + 1] interaction (row-major, as
        # jnp.triu_indices(k=1)); on the device, outside the state
        offsets = np.cumsum((0,) + config.vocab_sizes[:-1])
        self.register_buffer("_offsets", torch.tensor(offsets, device=device), persistent=False)
        self.register_buffer("_triu", torch.triu_indices(f + 1, f + 1, offset=1, device=device),
                             persistent=False)

    def sparse_param_names(self):
        """The fused table's name, as ``TrainStep`` keys it: the
        ``RowSparseAdam(sparse_params=...)`` input."""
        return ["embedding.weight"]

    def forward(self, dense, ids):
        return self.interact(dense, self.lookup(ids))

    def lookup(self, ids):
        """The table's rows of ``ids [B, F]`` (each feature's ids offset
        into the fused table): ``[B, F, D]``."""
        return self.embedding(ids + self._offsets.to(ids.dtype))

    def interact(self, dense, emb):
        """The logits of ``dense [B, num_dense]`` and the looked-up rows
        ``emb [B, F, D]``: the bottom MLP, the pairwise dot products and the
        top MLP."""
        bot = self.bottom(dense)                            # [B, D]
        z = torch.cat([bot[:, None, :], emb], dim=1)        # [B, F + 1, D]
        zz = torch.bmm(z, z.transpose(1, 2))                # [B, F + 1, F + 1]
        inter = zz[:, self._triu[0], self._triu[1]]         # [B, (F + 1) F / 2]
        return self.top(torch.cat([bot, inter], dim=-1))


class DLRMCriterion:
    """Binary cross-entropy with logits, the mean over the batch (the CTR
    objective), the reference's expression operation for operation:
    ``max(x, 0) - x y + log1p(exp(-|x|))`` in f32."""

    def __call__(self, logits, labels):
        x = logits.float().reshape(-1)
        y = labels.float().reshape(-1)
        return torch.mean(torch.maximum(x, x.new_zeros(())) - x * y
                          + torch.log1p(torch.exp(-torch.abs(x))))
