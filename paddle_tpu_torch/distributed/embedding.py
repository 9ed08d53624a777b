"""The recommender workload's embedding table (``paddle_tpu/distributed/embedding.py``):
one table, or a table row-sharded over a fleet axis with the reference's
exchange.

:class:`ShardedEmbedding` holds a ``[padded_rows, D]`` table, padded to a
multiple of ``pad_multiple`` rows and drawn Normal(0, 1). An id outside
``[0, num_embeddings)`` gives the zero row. On one shard the lookup is
``torch.nn.functional.embedding``'s, whose backward is a sorted segment
reduction, deterministic on the card (no atomics).

Built under a fleet whose ``axis`` group (``dp``) has n > 1 ranks, or given
that grid as ``mesh``, each rank holds rows ``[r V / n, (r + 1) V / n)`` of
the table drawn whole from the same generator, and looks its block of the
batch up through :func:`sharded_embedding_lookup`: the reference's
``_local_lookup`` (``shard_map`` over the mesh) step for step, one process
per rank over ``torch.distributed``.

- **lookup**: the rank's ids are deduplicated (a stable sort; the sorted
  unique ids, padded to the rank's token count with the sentinel
  ``v_pad`` = V, arrive grouped by owner ``id // (V / n)``), placed at
  their offset from their owner's run start in an ``[n, cap]`` id block,
  exchanged with one ``all_to_all``, gathered from the owner's local rows
  and sent back with a second; an inverse permutation puts the rows back
  in request order. Out-of-range ids and ids past an owner's ``capacity``
  give the zero row.
- **gradient**: token-level, stable-sorted by owner, so every row's
  contributions reach its owner in global token order (rank d holds the
  d-th block of the global batch). ``[n, T]`` gradient and id
  ``all_to_all``s, then the owner accumulates the received rows by
  ``aten.embedding_dense_backward`` over ``(local row, gradient)`` pairs:
  the same per-row chain as a one-process ``F.embedding`` backward over
  the global batch, so lookup and gradient are bitwise equal to it,
  duplicates across shards included.

The dedup, the run starts and the bucketing are sort, cumsum and scatter
on the device, and every exchange has a static size; the one host sync of
a lookup is the all-gather of the ranks' id counts that checks they are
equal (unequal counts raise ``ValueError`` on every rank). Under gloo the
``all_to_all``s of CUDA tensors go through pinned host memory
(:mod:`.collective`).

The table's weight carries ``dist_spec = (axis,)``, the reference's
parameter spec, and when split its ``expert_group`` (the ``axis`` group):
the reducers and clips treat it as they treat a mixture of experts' shard
(the owner keeps the gradient of its rows, divided by the group's size),
and the checkpoint converter joins and cuts it over that group, as
``utils.convert.expert_split_names`` names it
(:mod:`paddle_tpu_torch.distributed.converter`).

:class:`EmbeddingCheckpointRotation` publishes the training state every
``every`` steps through :class:`~.resilience.CheckpointManager`, which
writes the table whole: a checkpoint taken at dp 4 restores at dp 2 and
back, bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..framework.device import resolve_device
from ..framework.selected_rows import in_compiled_step, record_rows
from ..nn import initializer as I
from ..observability import runlog
from ..observability.metrics import counter_inc
from . import collective as C

__all__ = ["ShardedEmbedding", "sharded_embedding_lookup", "exchange_stats",
           "EmbeddingCheckpointRotation"]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _axis_group(mesh, axis):
    """The group of ``axis`` on ``mesh`` (the fleet's grid, or a collective
    ``Group`` itself; None: the active fleet's grid), or None without one."""
    if isinstance(mesh, C.Group):
        return mesh
    if mesh is None:
        from .fleet import fleet

        mesh = fleet.get_hybrid_communicate_group()
        if mesh is None:
            return None
    from .topology import HybridCommunicateGroup

    if not isinstance(mesh, HybridCommunicateGroup):
        raise TypeError("mesh must be the fleet's HybridCommunicateGroup or a collective Group, "
                        f"got {type(mesh).__name__}")
    return mesh.group(axis)


def _run_starts(owner_eff, n):
    """Each entry's offset from the start of its owner's run (``owner_eff``
    non-decreasing, in ``[0, n]``): bucket sizes by a scatter-add, run
    starts by an exclusive cumsum (the reference's ``_positions``)."""
    counts = torch.zeros(n + 1, dtype=torch.int64, device=owner_eff.device)
    counts.scatter_add_(0, owner_eff, torch.ones_like(owner_eff))
    starts = torch.cumsum(counts, 0) - counts
    return torch.arange(owner_eff.numel(), device=owner_eff.device) - starts[owner_eff]


def _check_counts(group, tokens, device):
    """Every rank of ``group`` looks up ``tokens`` ids, or all raise: the
    exchange's blocks must have one size on every rank. One all-gather of
    the counts each lookup (no rank can skip it alone: a rank that did
    would leave the others waiting)."""
    mine = torch.tensor([tokens], dtype=torch.int64, device=device)
    counts = [int(c) for c in C.all_gather(mine, group=group).reshape(-1).tolist()]
    if len(set(counts)) != 1:
        raise ValueError(f"sharded_embedding_lookup: the ranks of {group.axis_name or 'the group'} "
                         f"look up {counts} ids; the batch must split evenly over its "
                         f"{group.nranks} ranks")


class _Exchange(torch.autograd.Function):
    """The per-rank exchange body: ``ids`` ``[T]`` (int64), ``table`` this
    rank's ``[v_local, D]`` rows."""

    @staticmethod
    def forward(ctx, table, ids, group, num_emb, cap, record):
        n, me = group.nranks, group.rank
        v_local = table.shape[0]
        v_pad = v_local * n  # outside every shard's range: a padded slot never aliases a row
        T = ids.numel()
        valid = (ids >= 0) & (ids < num_emb)
        ids_s = torch.where(valid, ids, v_pad)
        # unique ids at a static size T: a stable sort, run heads, and the
        # inverse; the sorted result is already grouped by owner
        sorted_ids, perm = torch.sort(ids_s, stable=True)
        head = torch.ones_like(sorted_ids, dtype=torch.bool)
        head[1:] = sorted_ids[1:] != sorted_ids[:-1]
        u_of_sorted = torch.cumsum(head, 0) - 1
        inv = torch.empty_like(u_of_sorted)
        inv[perm] = u_of_sorted
        uniq = torch.full_like(ids_s, v_pad)
        uniq[u_of_sorted] = sorted_ids  # duplicates write the same value
        u_valid = uniq < v_pad
        owner = torch.where(u_valid, uniq // v_local, n)
        pos = _run_starts(owner, n)
        keep = u_valid & (pos < cap)
        # the id block: row d holds what I ask shard d for; a dropped entry
        # goes to the extra slot n * cap, cut off before the exchange
        slot = torch.where(keep, owner * cap + pos, n * cap)
        send = torch.full((n * cap + 1,), v_pad, dtype=torch.int32, device=ids.device)
        send[slot] = uniq.to(torch.int32)
        recv = C.alltoall(send[:n * cap], group=group).long()  # what shard d asks me for
        if record is not None:
            rows = torch.unique(recv[recv < v_pad] - me * v_local)
            record_rows(record, rows)
            counter_inc("embedding.rows_touched", int(rows.numel()))
        lidx = (recv - me * v_local).clamp(0, v_local - 1)
        back = C.alltoall(table.index_select(0, lidx), group=group)  # [n * cap, D]
        got = back[owner.clamp(max=n - 1) * cap + pos.clamp(0, cap - 1)]
        tok_live = valid & keep[inv]  # out of range or dropped by the capacity: the zero row
        out = torch.where(tok_live[:, None], got[inv], 0.0)
        ctx.save_for_backward(ids_s, tok_live)
        ctx.group, ctx.v_local = group, v_local
        return out

    @staticmethod
    def backward(ctx, dy):
        ids_s, tok_live = ctx.saved_tensors
        group, v_local = ctx.group, ctx.v_local
        n, me = group.nranks, group.rank
        v_pad = v_local * n
        T = ids_s.numel()
        # token-level routing, stable-sorted by owner: the owner's received
        # (peer, slot) order is global token order
        owner = torch.where(tok_live, ids_s // v_local, n)
        order = torch.argsort(owner, stable=True)
        owner_s = owner[order]
        pos = _run_starts(owner_s, n)
        slot = torch.where(owner_s < n, owner_s * T + pos, n * T)
        send_g = dy.new_zeros((n * T + 1, dy.shape[1]))
        send_g[slot] = dy[order]
        send_i = torch.full((n * T + 1,), v_pad, dtype=torch.int32, device=dy.device)
        send_i[slot] = ids_s[order].to(torch.int32)
        g_recv = C.alltoall(send_g[:n * T], group=group)
        i_recv = C.alltoall(send_i[:n * T], group=group).long()
        # the row-sparse push: empty slots land on the extra row v_local
        lidx = torch.where(i_recv < v_pad, i_recv - me * v_local, v_local)
        d_table = torch.ops.aten.embedding_dense_backward(g_recv, lidx, v_local + 1, -1, False)
        return d_table[:v_local], None, None, None, None, None


def sharded_embedding_lookup(ids, table, mesh, axis: str = "dp",
                             num_embeddings: Optional[int] = None,
                             capacity: Optional[int] = None, *, _record=None):
    """Row-sharded lookup over ``mesh``'s ``axis`` group (the fleet's
    ``HybridCommunicateGroup``, or a collective ``Group``).

    ``table`` is this rank's ``[V / n, D]`` rows (rank r holds rows ``[r V /
    n, (r + 1) V / n)`` of the global ``[V, D]``); ``ids`` (any int shape)
    is this rank's block of the batch, the same size on every rank.
    ``num_embeddings`` bounds the valid id range (default V): ids outside
    it give the zero row. ``capacity`` caps the unique ids a rank asks one
    owner for; the rest give the zero row (the default, this rank's token
    count, is exact). Returns ``ids.shape + (D,)``, differentiable in
    ``table``. ``_record``: the weight on which to record the rows the
    exchange asked this rank for (the eager lazy optimizers' rows)."""
    group = _axis_group(mesh, axis)
    n = 1 if group is None else group.nranks
    V, D = int(table.shape[0]) * n, int(table.shape[1])
    num_emb = V if num_embeddings is None else int(num_embeddings)
    if n == 1:
        bad = (ids < 0) | (ids >= num_emb)
        return torch.where(bad[..., None], 0.0, F.embedding(ids.clamp(0, V - 1), table))
    t_local = ids.numel()
    _check_counts(group, t_local, ids.device)
    cap = t_local if capacity is None else max(1, min(int(capacity), t_local))
    out = _Exchange.apply(table, ids.reshape(-1).long(), group, num_emb, cap, _record)
    return out.reshape(*ids.shape, D)


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
    """An embedding table row-sharded over the fleet axis ``axis``.

    ``num_embeddings`` is the valid id range; the table has
    ``padded_rows`` rows (a multiple of ``pad_multiple``). ``mesh``: the
    fleet's grid (None: the active fleet's, if any); when its ``axis``
    group has n > 1 ranks this rank keeps its ``padded_rows / n`` rows
    (``rows`` is the range) and looks up through
    :func:`sharded_embedding_lookup`, else it holds the whole table.

    Each forward counts ``embedding.lookups``; a sharded one also counts
    this rank's ``embedding.ids_exchanged`` and its share of
    ``embedding.a2a_bytes`` (``bytes_total / n``, so the ranks' counts sum
    to the reference's) and emits an ``embedding_exchange`` run-log event
    with the global lookup's :func:`exchange_stats`. A gradient-taking
    forward outside a ``TrainStep`` records the looked-up rows on the
    weight (the ``Embedding(sparse=True)`` contract, for the lazy eager
    optimizers; sharded: the owner's local rows that the exchange asked
    for) and counts them in ``embedding.rows_touched``. The reference
    records every unique id, an out-of-range one too; the port records the
    ids in range, whose rows alone it can index.

    ``device`` (None: the card) and ``generator`` place and draw the
    table; a shard draws the whole table and keeps its rows, so the
    generator advances as on one shard."""

    def __init__(self, num_embeddings: int, embedding_dim: int, axis: str = "dp", mesh=None,
                 capacity: Optional[int] = None, pad_multiple: int = 8, weight_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        if weight_attr is not None:
            raise NotImplementedError("ShardedEmbedding: weight_attr is not ported")
        device = resolve_device(device)
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.axis = axis
        self.capacity = capacity
        self.padded_rows = _round_up(self.num_embeddings, max(1, pad_multiple))
        group = _axis_group(mesh, axis)
        self.group = group if group is not None and group.nranks > 1 else None
        n = 1 if self.group is None else self.group.nranks
        if self.padded_rows % n:
            raise ValueError(
                f"sharded_embedding_lookup: table rows {self.padded_rows} not divisible by mesh "
                f"axis {axis!r} degree {n}; pad the table (ShardedEmbedding pad_multiple handles "
                "this at construction)")
        full = I.normal((self.padded_rows, self.embedding_dim), 1.0, generator, device)
        v_local = self.padded_rows // n
        r = 0 if self.group is None else self.group.rank
        self.rows = (r * v_local, (r + 1) * v_local)
        self.weight = nn.Parameter(full if n == 1 else full[self.rows[0]:self.rows[1]].clone())
        del full
        self.weight.dist_spec = (axis,)
        if self.group is not None:
            self.weight.expert_group = self.group

    def forward(self, x):
        counter_inc("embedding.lookups")
        record = (self.weight.requires_grad and torch.is_grad_enabled()
                  and not in_compiled_step())
        if self.group is None:
            bad = (x < 0) | (x >= self.num_embeddings)
            if record:
                rows = torch.unique(x[~bad])
                record_rows(self.weight, rows)
                counter_inc("embedding.rows_touched", int(rows.numel()))
            out = F.embedding(x.clamp(0, self.padded_rows - 1), self.weight)
            return torch.where(bad[..., None], 0.0, out)
        n = self.group.nranks
        stats = exchange_stats(x.numel() * n, self.num_embeddings, self.embedding_dim, n,
                               self.capacity, self.weight.element_size())
        counter_inc("embedding.ids_exchanged", x.numel())
        counter_inc("embedding.a2a_bytes", stats["bytes_total"] // n)
        runlog.emit("embedding_exchange", axis=self.axis, traced=in_compiled_step(), **stats)
        return sharded_embedding_lookup(x, self.weight, self.group, axis=self.axis,
                                        num_embeddings=self.num_embeddings,
                                        capacity=self.capacity,
                                        _record=self.weight if record else None)

    def exchange_stats(self, batch_tokens: int, shards: Optional[int] = None) -> dict:
        """Static per-step exchange accounting for a ``batch_tokens``-id
        lookup over ``shards`` devices (default: this table's shards)."""
        if shards is None:
            shards = 1 if self.group is None else self.group.nranks
        return exchange_stats(batch_tokens, self.num_embeddings, self.embedding_dim, shards,
                              self.capacity, self.weight.element_size())

    def extra_repr(self):
        return (f"num_embeddings={self.num_embeddings} (padded {self.padded_rows}, rows "
                f"{self.rows[0]}:{self.rows[1]} here), dim={self.embedding_dim}, "
                f"axis={self.axis!r}")


def _table_rows(state, names):
    """The global row count of the tables ``names`` in ``state`` (a
    ``TrainStep``, whose split tables count every shard's rows, or a
    state tree with ``params``)."""
    if hasattr(state, "model") and hasattr(state, "optimizer"):
        params = dict(state.model.named_parameters())
        return sum(int(params[n].shape[0]) * getattr(getattr(params[n], "expert_group", None),
                                                      "nranks", 1)
                   for n in names if n in params)
    params = state.get("params", {}) if isinstance(state, dict) else {}
    return sum(int(params[n].shape[0]) for n in names if n in params)


class EmbeddingCheckpointRotation:
    """Online-learning checkpoint hook (the reference's): every ``every``
    optimizer steps the training state (a ``TrainStep``, written whole over
    its mesh, or a state tree) is published through ``manager``, a
    :class:`~.resilience.CheckpointManager` (its ``keep_last_k`` rotates
    them), and ``embedding.rows_checkpointed`` counts the rows of the
    tables named in ``table_names``. :meth:`restore` converts the newest
    valid checkpoint onto any mesh: a ``TrainStep`` target at dp 2 gets its
    rows of a table saved at dp 4, bitwise."""

    def __init__(self, manager, every: int = 100, table_names=()):
        if int(every) < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.manager = manager
        self.every = int(every)
        self.table_names = tuple(table_names)
        self._last_saved: Optional[int] = None

    def maybe_save(self, state, step: int) -> Optional[str]:
        """Publish ``state`` when ``step`` crosses the rotation period;
        returns the checkpoint path or None when not due."""
        if self._last_saved is not None and step - self._last_saved < self.every:
            return None
        return self.save(state, step)

    def save(self, state, step: int) -> str:
        from ..stability import state_to_savable

        savable = state if hasattr(state, "optimizer") else state_to_savable(state)
        path = self.manager.save(savable, int(step))
        rows = _table_rows(state, self.table_names)
        if rows:
            counter_inc("embedding.rows_checkpointed", rows)
        self._last_saved = int(step)
        return path

    def restore(self, target=None, shardings=None):
        """``(state, step)`` from the newest valid checkpoint, converted onto
        ``target`` (a ``TrainStep``: its rank's pieces are loaded into it;
        or a savable tree) and ``shardings``; None when there is none."""
        from ..stability import state_from_savable

        got = self.manager.restore_latest(target=target, shardings=shardings)
        if got is None:
            return None
        state, step = got
        if hasattr(state, "optimizer"):  # a TrainStep target, loaded in place
            state = state.state
        return state_from_savable(state), step
