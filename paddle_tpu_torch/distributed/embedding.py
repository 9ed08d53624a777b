"""The recommender workload's embedding table (``paddle_tpu/distributed/embedding.py``),
in its single-shard form.

:class:`ShardedEmbedding` holds one ``[padded_rows, D]`` table, padded to a
multiple of ``pad_multiple`` rows and drawn Normal(0, 1), and looks ids up
with the reference's single-shard semantics: an id outside
``[0, num_embeddings)`` gives the zero row, whose gradient adds exactly zero
to the row it was clamped to. The backward is ``torch.nn.functional.embedding``'s,
a sorted segment reduction, deterministic on the card (no atomics).

The reference's row-sharded exchange over a mesh (``sharded_embedding_lookup``:
two ``all_to_all`` pairs inside ``shard_map``) and
``EmbeddingCheckpointRotation`` wait for the distributed slice: they, and a
mesh whose degree over the table's axis is above 1, raise
``NotImplementedError`` (ROADMAP.md, Queue 1 item 13d).
:func:`exchange_stats`, the shape-derived exchange accounting, is ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..framework.device import resolve_device
from ..framework.selected_rows import in_compiled_step, record_rows
from ..nn import initializer as I
from ..observability.metrics import counter_inc

__all__ = ["ShardedEmbedding", "sharded_embedding_lookup", "exchange_stats",
           "EmbeddingCheckpointRotation"]

_NOT_PORTED = "{} is not ported yet: the sharded exchange waits for ROADMAP.md, Queue 1 item 13d"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _degree(mesh, axis) -> int:
    """The mesh's degree over ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(dict(getattr(mesh, "shape", {})).get(axis, 1))


def sharded_embedding_lookup(ids, table, mesh, axis="dp", num_embeddings=None, capacity=None):
    raise NotImplementedError(_NOT_PORTED.format("sharded_embedding_lookup"))


def exchange_stats(batch_tokens: int, vocab: int, dim: int, shards: int,
                   capacity: Optional[int] = None, itemsize: int = 4) -> dict:
    """Static per-step exchange accounting for one lookup over ``shards``
    devices: the ids and embedding payload bytes of the forward and the
    backward ``all_to_all`` pairs, summed over devices (diagonal included),
    from shapes alone (the reference's function)."""
    t_local = max(1, batch_tokens // max(1, shards))
    cap = t_local if capacity is None else max(1, min(int(capacity), t_local))
    ids_fwd = shards * shards * cap * 4
    emb_fwd = shards * shards * cap * dim * itemsize
    ids_bwd = shards * shards * t_local * 4
    emb_bwd = shards * shards * t_local * dim * itemsize
    return {
        "shards": shards, "ids": batch_tokens, "capacity": cap,
        "bytes_ids": ids_fwd + ids_bwd,
        "bytes_emb": emb_fwd + emb_bwd,
        "bytes_total": ids_fwd + emb_fwd + ids_bwd + emb_bwd,
        "vocab": vocab, "dim": dim,
    }


class ShardedEmbedding(nn.Module):
    """An embedding table that the reference row-shards over the mesh axis
    ``axis``; here one shard. ``num_embeddings`` is the valid id range; the
    stored table has ``padded_rows`` rows. Each forward counts
    ``embedding.lookups``; a gradient-taking forward outside a ``TrainStep``
    also records its valid rows on the weight (the ``Embedding(sparse=True)``
    contract, for the lazy eager optimizers) and counts them in
    ``embedding.rows_touched``. The reference records every unique id, an
    out-of-range one too; the port records the ids in range, whose rows
    alone it can index.

    ``device`` (None: the card) and ``generator`` place and draw the table."""

    def __init__(self, num_embeddings: int, embedding_dim: int, axis: str = "dp", mesh=None,
                 capacity: Optional[int] = None, pad_multiple: int = 8, weight_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        if _degree(mesh, axis) > 1:
            raise NotImplementedError(_NOT_PORTED.format("ShardedEmbedding over a mesh"))
        if weight_attr is not None:
            raise NotImplementedError("ShardedEmbedding: weight_attr is not ported")
        device = resolve_device(device)
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.axis = axis
        self.capacity = capacity
        self.padded_rows = _round_up(self.num_embeddings, max(1, pad_multiple))
        self.weight = nn.Parameter(
            I.normal((self.padded_rows, self.embedding_dim), 1.0, generator, device))

    def forward(self, x):
        bad = (x < 0) | (x >= self.num_embeddings)
        if self.weight.requires_grad and torch.is_grad_enabled() and not in_compiled_step():
            rows = torch.unique(x[~bad])
            record_rows(self.weight, rows)
            counter_inc("embedding.rows_touched", int(rows.numel()))
        counter_inc("embedding.lookups")
        out = F.embedding(x.clamp(0, self.padded_rows - 1), self.weight)
        return torch.where(bad[..., None], 0.0, out)

    def exchange_stats(self, batch_tokens: int, shards: Optional[int] = None) -> dict:
        """Static per-step exchange accounting for a ``batch_tokens``-id
        lookup over ``shards`` devices (1 here by default)."""
        return exchange_stats(batch_tokens, self.num_embeddings, self.embedding_dim,
                              1 if shards is None else shards, self.capacity,
                              self.weight.element_size())

    def extra_repr(self):
        return (f"num_embeddings={self.num_embeddings} (padded {self.padded_rows}), "
                f"dim={self.embedding_dim}, axis={self.axis!r}")


class EmbeddingCheckpointRotation:
    """Periodic row-sharded checkpoint publication of the table (the
    reference's online-learning hook); not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("EmbeddingCheckpointRotation"))
