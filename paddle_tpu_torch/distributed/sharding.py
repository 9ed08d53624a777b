"""ZeRO sharding of the port (``paddle_tpu/distributed/sharding.py``;
parity: GroupShardedOptimizerStage2,
fleet/meta_parallel/sharding/group_sharded_optimizer_stage2.py:48,
GroupShardedStage3 group_sharded_stage3.py:60, and the public API
python/paddle/distributed/sharding/group_sharded.py).

The reference's stage is a ``PartitionSpec`` policy over the ``sdp`` mesh
axis, and XLA emits the collectives. The port's :class:`ZeroPlan` is the
partition plan those specs stand for, run by hand over the ``sdp`` group:

- the plan (:func:`partition_dim`, the reference's ``_extend_spec``): a
  parameter of at least :data:`MIN_SIZE` entries (counted whole, before
  its ``mp`` and ``pp`` splits) is split over the ``sdp`` ranks along one
  dim of the tensor a rank holds: its ``mp`` split dim (``mp_axis``, the
  dim its tensor-parallel layout splits, at any mp degree) when that divides,
  else its largest dim that divides (never the ``[L, ...]`` layer dim of a
  stacked trunk, which is ``pp``'s); smaller ones stay replicated. Rank i
  owns the i-th of ``sdp`` equal blocks along that dim, of the parameter
  and of its optimizer state;
- stage 1 (``os``): the gradients are averaged over the data group
  (``dp`` x ``sdp``) whole; each rank updates its own block, and the
  blocks are all-gathered over ``sdp``;
- stage 2 (``os_g``): a split parameter's gradient is reduce-scattered
  over ``sdp`` and all-reduced over ``dp``; the rest as stage 1;
- stage 3 (``p_g_os``): a split parameter is held as its block. A module
  that declares ``zero_gathers_own = True`` (the stacked GPT trunk)
  all-gathers each layer's blocks as it uses them and frees them after,
  gathering them again in the backward (:func:`regather_on_backward`); the
  others get their parameters gathered as the step's forward begins
  (:func:`gather_param`). The gather's backward reduce-scatters the
  gradient over ``sdp``, which is then all-reduced over ``dp``.

AdamW is elementwise, so an update over blocks is the update over the
whole. Lamb's trust ratio and the global-norm clip need whole norms: the
squares of a split gradient are all-reduced over ``sdp`` (the parameter's
``zero_group``), as the shards' are over ``mp``.

The reference's ``place_state`` is a workaround for JAX's buffer donation
(a replicated ``device_put`` could alias the model's own array, which the
donated step then deletes); the port donates nothing, so it has no
counterpart. ``offload=True`` keeps the optimizer state in pinned host
memory, as the reference's ``memory_kind="pinned_host"`` state shardings
do: the update streams it through the card chunk by chunk
(``Optimizer._offload``), bitwise the same step. The parameters (the f32
masters under O2) stay on the card, as the reference's do.
"""
from __future__ import annotations

import contextlib
import math

import torch

from . import collective as C

#: Parameters with fewer entries stay replicated (the reference's ``min_size``).
MIN_SIZE = 16384
#: ``group_sharded_parallel``'s levels and their stages.
LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def partition_dim(shape, sdp, whole_numel=None, mp_axis=None, exclude=()):
    """The dim of a held tensor of ``shape`` that ZeRO splits over ``sdp``
    ranks, or None for a replicated one. ``whole_numel``: the parameter's
    entries before its ``mp``/``pp`` splits (the size test's);
    ``mp_axis``: its ``mp`` split dim; ``exclude``: dims never split."""
    numel = math.prod(shape) if whole_numel is None else whole_numel
    if sdp <= 1 or numel < MIN_SIZE:
        return None
    if mp_axis is not None and shape[mp_axis] % sdp == 0:
        return mp_axis
    cand = [(n, i) for i, n in enumerate(shape) if i not in exclude and n % sdp == 0]
    return max(cand)[1] if cand else None


def held_dim(p, hcg):
    """:func:`partition_dim` of parameter ``p`` as a rank holds it before
    stage 3 splits it (its ``zero_full_shape`` once it does)."""
    shape = getattr(p, "zero_full_shape", tuple(p.shape))
    whole = math.prod(shape)
    if getattr(p, "mp_group", None) is not None:
        whole *= p.mp_group.nranks
    if getattr(p, "stacked_layers", False):
        whole *= hcg.get_pipe_parallel_world_size()
    return partition_dim(shape, hcg.get_sharding_parallel_world_size(), whole_numel=whole,
                         mp_axis=getattr(p, "mp_axis", None),
                         exclude=(0,) if getattr(p, "stacked_layers", False) else ())


def _block(t, dim, group):
    """``group``'s rank's block of ``t`` along ``dim`` (a view)."""
    n = t.shape[dim] // group.nranks
    return t.narrow(dim, group.rank * n, n)


class _GatherBlocks(torch.autograd.Function):
    """All-gather of the ``sdp`` blocks along ``dim`` forward; the
    reduce-scatter (sum) of the gradient back to this rank's block."""

    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.group = dim, group
        return C.all_gather_concat(block, group=group, concat_axis=dim)

    @staticmethod
    def backward(ctx, g):
        return C.reduce_scatter(None, g, group=ctx.group, scatter_axis=ctx.dim), None, None


def gather_param(block, dim, group):
    """The whole tensor of a stage-3 ``block`` (split along ``dim`` over
    ``group``); its gradient reduce-scatters back to the block."""
    if dim is None or group is None or group.nranks == 1:
        return block
    return _GatherBlocks.apply(block, dim, group)


_REGATHER = object()


@contextlib.contextmanager
def regather_on_backward(gathered):
    """Inside the context, a tensor that autograd saves and that shares its
    storage with one of ``gathered`` (``(whole, block, dim, group)``
    tuples, the whole made by :func:`gather_param`) is saved as its block:
    the backward gathers it again when it needs it, so no gathered weight
    outlives its layer's forward."""
    by_storage = {w.untyped_storage().data_ptr(): (b.detach(), d, g) for w, b, d, g in gathered
                  if w is not b}

    def pack(t):
        info = by_storage.get(t.untyped_storage().data_ptr()) if t.device.type != "meta" else None
        if info is None:
            return t
        return (_REGATHER, *info, tuple(t.shape), t.stride(), t.storage_offset())

    def unpack(x):
        if not (isinstance(x, tuple) and x and x[0] is _REGATHER):
            return x
        _, block, dim, group, shape, stride, offset = x
        whole = C.all_gather_concat(block, group=group, concat_axis=dim)
        return whole.as_strided(shape, stride, offset)

    if not by_storage:
        yield
        return
    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


class ZeroPlan:
    """The partition plan of one model's parameters at a ZeRO ``stage``
    over the fleet's grid ``hcg``, and the step's pass around the update:
    :meth:`reduce` after the backward, :meth:`gather` after the update.

    ``parts`` maps a parameter's ``id`` to its split dim (None:
    replicated). The optimizer updates :meth:`local` with :meth:`grad`."""

    def __init__(self, params, stage, hcg, names=None):
        from .parallel import _BucketReducer

        if stage not in (1, 2, 3):
            raise ValueError(f"ZeRO stage must be 1, 2 or 3, got {stage}")
        self.stage, self.hcg = int(stage), hcg
        self.sdp = hcg.get_sharding_parallel_group()
        self.dp = hcg.get_data_parallel_group()
        self.data = hcg.get_data_sharding_group()
        self.params = [p for p in params if p.requires_grad]
        self.parts = {id(p): held_dim(p, hcg) for p in self.params}
        self.split = [p for p in self.params if self.parts[id(p)] is not None]
        whole = [p for p in self.params if self.parts[id(p)] is None]
        # stage 1 averages every gradient whole; stages 2 and 3 the
        # replicated ones (and the loss, which rides the last bucket)
        self._reducer = _BucketReducer(self.params if self.stage == 1 else whole,
                                       group=self.data, names=names)
        self._grads = {}
        for p in self.split:
            p.zero_group = self.sdp  # the optimizer sees its block: norms sum over sdp
        if self.stage == 3:
            self._split_params()

    def _split_params(self):
        with torch.no_grad():
            for p in self.split:
                if not hasattr(p, "zero_full_shape"):
                    p.zero_full_shape = tuple(p.shape)
                    p.data = _block(p.data, self.parts[id(p)], self.sdp).clone()

    # -- what the optimizer updates ------------------------------------------
    def part(self, p):
        return self.parts.get(id(p))

    def local(self, p):
        """This rank's block of ``p`` (a view; ``p`` itself at stage 3 or
        when ``p`` is replicated)."""
        dim = self.parts.get(id(p))
        if dim is None or self.stage == 3:
            return p
        return _block(p, dim, self.sdp)

    def grad(self, p):
        """The averaged gradient of :meth:`local` after :meth:`reduce`."""
        return self._grads.get(id(p))

    # -- the step's pass ------------------------------------------------------
    @torch.no_grad()
    def reduce(self, extra=None):
        """Average the gradients over the data group (``dp`` x ``sdp``) in
        the stage's way and keep each rank's block of them; ``extra`` (the
        loss) rides along and comes back averaged."""
        out = self._reducer.reduce(find_unused_parameters=True, extra=extra)
        n = self.data.nranks
        self._grads = {}
        for p in self.params:
            if p.grad is None:
                continue
            dim = self.parts[id(p)]
            if dim is None:
                self._grads[id(p)] = p.grad
            elif self.stage == 1:
                self._grads[id(p)] = _block(p.grad, dim, self.sdp)
            else:
                g = p.grad if self.stage == 3 else C.reduce_scatter(
                    None, p.grad, group=self.sdp, scatter_axis=dim)
                if self.dp.nranks > 1:
                    g = C.all_reduce(g.contiguous(), group=self.dp)
                self._grads[id(p)] = g.div_(n) if n > 1 else g
        return out

    @torch.no_grad()
    def gather(self):
        """After the update: at stages 1 and 2, every rank's block of each
        split parameter all-gathered over ``sdp`` into the parameter; the
        averaged gradients dropped."""
        self._grads = {}
        if self.stage == 3:
            return
        for p in self.split:
            dim = self.parts[id(p)]
            p.copy_(C.all_gather_concat(_block(p, dim, self.sdp), group=self.sdp,
                                        concat_axis=dim))


def state_shardings(model, hcg, stage=1):
    """Each parameter's split dim over ``sdp`` (None: replicated), by name:
    the port's counterpart of the reference's ``state_shardings``, whose
    ``PartitionSpec``s the dims stand for."""
    return {n: held_dim(p, hcg) if stage >= 1 else None for n, p in model.named_parameters()}


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None, group=None, offload=False,
                           sync_buffers=False, buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False):
    """API parity (python/paddle/distributed/sharding/group_sharded.py):
    ``level`` ``"os"`` (stage 1), ``"os_g"`` (stage 2) or ``"p_g_os"``
    (stage 3). Records the stage and ``offload`` (the optimizer state in
    pinned host memory) on the model and the optimizer for
    ``fleet.distributed_step`` (or a ``TrainStep`` over the fleet's grid)
    and returns them with ``scaler``."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {sorted(LEVELS)}, got {level!r}")
    stage = LEVELS[level]
    model._sharding_stage = optimizer._sharding_stage = stage
    model._sharding_offload = optimizer._sharding_offload = bool(offload)
    return model, optimizer, scaler
