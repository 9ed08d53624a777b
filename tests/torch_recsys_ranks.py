"""Rank bodies of ``tests/test_torch_recsys.py``: the row-sharded embedding
exchange, DLRM over a ``dp`` fleet and the table's checkpoint rotation.

Each function runs in every rank of a gloo world that
:func:`paddle_tpu_torch.testing.dist.run_ranks` spawned on the CPU and
returns picklable numpy results. This module imports torch, numpy and the
port only: a rank process never imports ``jax`` or ``paddle_tpu``.
"""
import torch


def _np(t):
    return t.detach().cpu().numpy()


def _fleet(dp):
    import paddle_tpu_torch.distributed as D

    s = D.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp}
    D.fleet.init(is_collective=True, strategy=s, device="cpu")
    return D.fleet


def imported_reference_modules():
    """The modules of ``jax`` or ``paddle_tpu`` this rank has imported, after
    one row-sharded lookup and its gradient, an AMP scope and an offloaded
    optimizer update."""
    import sys

    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.embedding import ShardedEmbedding
    from paddle_tpu_torch.optimizer import AdamW

    _fleet(D.get_world_size())
    emb = ShardedEmbedding(16, 4, device="cpu")
    with amp.auto_cast(dtype="bfloat16"):
        emb(torch.arange(4)).sum().backward()
    opt = AdamW(parameters=emb.parameters())
    opt._offload = True
    opt.step()
    D.fleet._hcg = None
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))


def _block(x, r, n):
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def lookups(table, batches):
    """For each ``(ids, cot, kwargs)`` batch: this rank's lookup of its block
    of ``ids`` through the sharded exchange (with ``kwargs``:
    ``num_embeddings``, ``capacity``), and the gradient of ``sum(o * cot)``
    over every rank's block on this rank's rows of ``table``."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.embedding import sharded_embedding_lookup

    fleet = _fleet(D.get_world_size())
    group = fleet.get_hybrid_communicate_group().group("dp")
    r, n = group.rank, group.nranks
    out = {}
    for kind, (ids, cot, kw) in batches.items():
        local = torch.from_numpy(_block(table, r, n)).requires_grad_()
        o = sharded_embedding_lookup(torch.from_numpy(_block(ids, r, n)), local,
                                     fleet.get_hybrid_communicate_group(), axis="dp", **kw)
        (o * torch.from_numpy(_block(cot, r, n))).sum().backward()
        out[kind] = (_np(o), _np(local.grad))
    D.fleet._hcg = None
    return out


def divisibility_errors():
    """The ``ValueError``s: a table whose rows the ranks do not divide, and
    ranks that look up different numbers of ids."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.embedding import (ShardedEmbedding,
                                                        sharded_embedding_lookup)

    fleet = _fleet(D.get_world_size())
    hcg = fleet.get_hybrid_communicate_group()
    got = []
    try:
        ShardedEmbedding(30, 4, pad_multiple=1, device="cpu")
    except ValueError as e:
        got.append(str(e))
    ids = torch.zeros(2 + hcg.get_data_parallel_rank(), dtype=torch.long)
    try:
        sharded_embedding_lookup(ids, torch.zeros(8, 4), hcg)
    except ValueError as e:
        got.append(str(e))
    D.fleet._hcg = None
    return got


def exchange_events(table, ids):
    """One no-grad ``ShardedEmbedding`` lookup of this rank's block: the
    ``embedding.*`` counters and the ``embedding_exchange`` events."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.embedding import ShardedEmbedding
    from paddle_tpu_torch.observability import metrics

    _fleet(D.get_world_size())
    metrics.reset_counters("embedding.")
    obs.monitor().clear()
    emb = ShardedEmbedding(table.shape[0], table.shape[1], device="cpu")
    r, n = emb.group.rank, emb.group.nranks
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(_block(table, r, n)))
        out = emb(torch.from_numpy(_block(ids, r, n)))
    D.fleet._hcg = None
    return dict(out=_np(out), counters=metrics.counters("embedding."),
                events=obs.monitor().events("embedding_exchange"))


def several(calls):
    """Each ``(name, args)`` of ``calls`` in turn: this module's function
    ``name`` on ``args``; their results, in order (one world for several
    bodies)."""
    return [globals()[name](*args) for name, args in calls]


def _dlrm_step(state, dp):
    """DLRM of the tiny config on a ``dp`` fleet with ``state``'s weights (this
    rank's rows of the table) and its step over ``RowSparseAdam``:
    ``fleet.distributed_step``, or a ``TrainStep`` over the fleet's grid
    when ``dp`` is 2 (both paths run)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.dlrm import DLRM, DLRMConfig, DLRMCriterion
    from paddle_tpu_torch.optimizer import RowSparseAdam
    from paddle_tpu_torch.utils.convert import expert_split_names, shard_state

    fleet = _fleet(dp)
    hcg = fleet.get_hybrid_communicate_group()
    model = DLRM(DLRMConfig.tiny(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in shard_state(
        state, ep_rank=hcg.get_data_parallel_rank(), ep_degree=dp,
        ep_names=expert_split_names(model)).items()})
    opt = RowSparseAdam(learning_rate=1e-2, parameters=model.parameters(),
                        sparse_params=model.sparse_param_names())
    if dp == 2:
        return TrainStep(model, opt, DLRMCriterion(), mesh=hcg), model, fleet
    return fleet.distributed_step(model, opt, DLRMCriterion()), model, fleet


def _feed(fleet, batch):
    (dense, ids), (labels,) = batch
    return fleet.shard_batch(dense, ids), (fleet.shard_batch(labels),)


def dlrm_steps(state, batches):
    """``run_steps`` over ``batches`` at dp = world: the losses, the rank's
    rows of the table and its moments, every MLP parameter, and the
    ``embedding.*`` counters."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.observability import metrics

    step, model, fleet = _dlrm_step(state, D.get_world_size())
    metrics.reset_counters("embedding.")
    out = step.run_steps([_feed(fleet, b) for b in batches])
    st = step.state
    return dict(loss=_np(out["loss"]), params={k: _np(v) for k, v in st["params"].items()},
                opt={k: _np(v["embedding.weight"]) for k, v in st["opt"].items()},
                rows=model.embedding.rows, counters=metrics.counters("embedding."))


def rotation_save(state, batches, ckpt):
    """dp = world: train on ``batches``, publish through the rotation at
    step 2 (and try again within the period); returns the whole state as
    the checkpoint holds it and the ``embedding.*`` counters."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.converter import gather_to_host
    from paddle_tpu_torch.distributed.embedding import EmbeddingCheckpointRotation
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    from paddle_tpu_torch.observability import metrics

    step, model, fleet = _dlrm_step(state, D.get_world_size())
    step.run_steps([_feed(fleet, b) for b in batches])
    metrics.reset_counters("embedding.")
    rot = EmbeddingCheckpointRotation(CheckpointManager(ckpt, keep_last_k=2), every=1,
                                      table_names=model.sparse_param_names())
    saved = rot.maybe_save(step, 2) is not None
    again = rot.maybe_save(step, 2)
    whole = gather_to_host(step)
    return dict(saved=saved, again=again, counters=metrics.counters("embedding."),
                whole={k: _np(v) if isinstance(v, torch.Tensor) else v
                       for k, v in _flat(whole).items()})


def rotation_restore(state, ckpt, ckpt_out, batch):
    """dp = world: restore the newest checkpoint of ``ckpt`` into a fresh
    step, publish it again under ``ckpt_out`` at step 3 (when given), take
    one more step on ``batch`` (when given); returns the restored step and
    the whole state as restored."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed.converter import gather_to_host
    from paddle_tpu_torch.distributed.embedding import EmbeddingCheckpointRotation
    from paddle_tpu_torch.distributed.resilience import CheckpointManager

    step, model, fleet = _dlrm_step(state, D.get_world_size())
    rot = EmbeddingCheckpointRotation(CheckpointManager(ckpt), every=1,
                                      table_names=model.sparse_param_names())
    _, at = rot.restore(target=step)
    whole = {k: _np(v) if isinstance(v, torch.Tensor) else v
             for k, v in _flat(gather_to_host(step)).items()}
    if ckpt_out is not None:
        EmbeddingCheckpointRotation(CheckpointManager(ckpt_out), every=1,
                                    table_names=model.sparse_param_names()).save(step, 3)
    loss = None
    if batch is not None:
        loss = _np(step.run_steps([_feed(fleet, batch)])["loss"])
    return dict(at=at, whole=whole, loss=loss)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}
