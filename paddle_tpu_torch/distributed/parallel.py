"""DataParallel, its bucketed gradient reducer and ``spawn`` of the port
(``paddle_tpu/distributed/parallel.py``; parity:
python/paddle/fluid/dygraph/parallel.py:419 DataParallel,
imperative/reducer.cc:127, python/paddle/distributed/spawn.py).

The reference's ``_BucketReducer`` averages each rank's gradients over a
fixed bucket plan; the port's does the same over ``torch.distributed``:
the plan is fixed at construction (parameters grouped by dtype, in order,
each bucket filled to ``comm_buffer_size`` MB; a parameter larger than the
budget gets a bucket of its own), and each bucket is one flat
``all_reduce`` (SUM, then a division by the group size), run once at the
end of the backward from a callback queued on the autograd engine by the
first gradient of the pass. ``TrainStep`` over a fleet grid reduces its f32
master gradients with the same reducer.

A mixture of experts' sharded weights and a row-sharded embedding table
(marked ``expert_group``, the ``dp`` group: :mod:`.moe`, :mod:`.embedding`)
are left out of the buckets: each owner keeps its own
experts' gradient, as GSPMD does for the reference's ``P("dp", ...)``
weights. That gradient is the sum of every rank's loss terms (their rows
came through the exchange), so the reducer divides it by the group size,
as it divides the averaged ones. Experts that every rank of a group above
one holds whole (a model built before ``fleet.init``) raise: each rank
would route its own tokens alone. With ``sum_group`` (the ``data_sep``
group at a sequence degree above 1: each ``sep`` rank holds other tokens
of the same rows) a bucket is summed over it and divided by the averaging
group's size.

At world size 1 ``DataParallel`` is a passthrough with no hooks, as the
reference's single controller is. Above 1 it broadcasts the parameters
and buffers from the group's rank 0 at construction (Paddle's
``sync_params_buffers``; under GSPMD the reference holds one copy and needs
none).
"""
from __future__ import annotations

import contextlib
import os
import socket
import weakref

import torch
import torch.distributed as dist
from torch import nn

from ..framework import random as _random
from . import collective
from .resilience import watchdog


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def expert_params(params, group):
    """The expert-sharded parameters among ``params`` (marked
    ``expert_group``), checked against the averaging ``group``: experts
    that every rank holds whole raise when the group has more than one
    rank, and a shard's group must be ``group``."""
    out = []
    for p in params:
        if not hasattr(p, "expert_group"):
            continue
        eg = p.expert_group
        if eg is None and group.nranks > 1:
            raise NotImplementedError(
                "a mixture of experts whose experts every rank holds whole, under data "
                f"parallelism over {group.nranks} ranks, would route each rank's tokens alone: "
                "build the model after fleet.init(dp_degree=n) so its experts shard over dp "
                "(ROADMAP.md, Queue 1 item 13c)")
        if eg is not None:
            if eg.ranks != group.ranks:
                raise NotImplementedError(
                    f"experts sharded over ranks {eg.ranks}, gradients averaged over "
                    f"{group.ranks}: expert parallelism needs the two to be the dp group "
                    "(ROADMAP.md, Queue 1 item 13c)")
            out.append(p)
    return out


class _BucketReducer:
    """Coalesced gradient averaging over ``group`` (the sum over
    ``sum_group`` divided by ``group``'s size, with one) along a fixed
    bucket plan: ``buckets`` is a list of ``(dtype name, [params])``;
    ``names`` maps a parameter's ``id`` to the name an error shows. Expert
    shards (``experts``) are divided by the group size and not reduced."""

    def __init__(self, params, comm_buffer_mb=25, group=None, names=None, sum_group=None):
        self.group = collective._group(group)
        self.sum_group = self.group if sum_group is None else collective._group(sum_group)
        self.names = names or {}
        budget = int(comm_buffer_mb * 1024 * 1024)
        params = list(params)
        self.experts = expert_params(params, self.group)
        local = {id(p) for p in self.experts}
        by_dtype = {}
        for p in params:
            if id(p) not in local:
                by_dtype.setdefault(_dtype_name(p.dtype), []).append(p)
        self.buckets = []
        for dt, ps in by_dtype.items():
            cur, cur_bytes = [], 0
            for p in ps:
                nbytes = p.numel() * p.element_size()
                if cur and cur_bytes + nbytes > budget:
                    self.buckets.append((dt, cur))
                    cur, cur_bytes = [], 0
                cur.append(p)
                cur_bytes += nbytes
            if cur:
                self.buckets.append((dt, cur))

    @property
    def nbytes(self):
        return sum(p.numel() * p.element_size() for _, ps in self.buckets for p in ps)

    @torch.no_grad()
    def reduce(self, find_unused_parameters=False, extra=None):
        """Average every planned parameter's ``.grad`` over the group, one
        flat all-reduce per bucket; each averaged gradient becomes a view
        of its bucket. A parameter with no gradient raises unless
        ``find_unused_parameters`` (then it adds zeros to the sum and keeps
        no gradient). Every bucket is reduced, so ranks whose passes used
        different parameters still issue the same collectives. ``extra``
        (a tensor, e.g. the loss) rides at the end of the last bucket of
        its dtype and comes back averaged (over ``group``: every rank of one
        ``sum_group`` slice holds the same value)."""
        with torch.no_grad():
            for p in self.experts:
                if p.grad is not None:
                    p.grad.div_(self.group.nranks)
        if extra is not None and self.sum_group is not self.group:
            extra = extra / (self.sum_group.nranks // self.group.nranks)
        all_ps = [p for _, ps in self.buckets for p in ps]
        if not any(p.grad is not None for p in all_ps):
            return None if extra is None else self._average(extra.reshape(-1).clone()).view_as(extra)
        if not find_unused_parameters and any(p.grad is None for p in all_ps):
            missing = [self.names.get(id(p), "<unnamed>") for p in all_ps if p.grad is None]
            raise RuntimeError(
                "DataParallel: these parameters produced no gradient: "
                f"{missing}. Pass find_unused_parameters=True if parts of "
                "the model are intentionally unused (reference reducer "
                "semantics).")
        rider = None
        if extra is not None:
            rider = max((i for i, (dt, _) in enumerate(self.buckets)
                         if dt == _dtype_name(extra.dtype)), default=None)
        out = None
        for i, (_, ps) in enumerate(self.buckets):
            parts = [p.grad.reshape(-1) if p.grad is not None else p.new_zeros(p.numel())
                     for p in ps]
            if i == rider:
                parts.append(extra.reshape(-1))
            # the watchdog (armed by FLAGS_collective_timeout_s) names the
            # bucket a dead peer leaves pending
            with watchdog(f"ddp all-reduce bucket {i} ({self.buckets[i][0]}, "
                          f"{len(ps)} params)"):
                flat = self._average(torch.cat(parts))
            off = 0
            for p in ps:
                if p.grad is not None:
                    p.grad = flat[off:off + p.numel()].view_as(p)
                off += p.numel()
            if i == rider:
                out = flat[off:].view_as(extra)
        if extra is not None and out is None:
            out = self._average(extra.reshape(-1).clone()).view_as(extra)
        return out

    def _average(self, flat):
        collective.all_reduce(flat, group=self.sum_group)
        return flat.div_(self.group.nranks)


def _default_group(group):
    if group is not None or not dist.is_initialized():
        return group
    return collective._group(None)


class DataParallel(nn.Module):
    """Parity: python/paddle/fluid/dygraph/parallel.py:419. Above one rank,
    every ``backward`` that reaches the wrapped layers' parameters ends
    with their gradients averaged over ``group`` (the fleet's ``dp`` group,
    or the world)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        group = _default_group(group)
        self._grad_sync = group is not None and collective._group(group).nranks > 1
        self._sync_enabled = True
        self._hook_handles = []
        # each rank's dropout draws from the stream with its rank folded in
        self._rank = collective._group(group).rank if self._grad_sync else None
        if not self._grad_sync:
            return
        g = collective._group(group)
        experts = {id(p) for p in expert_params(layers.parameters(), g)}
        with torch.no_grad():  # each rank keeps its own experts
            for t in list(layers.parameters()) + list(layers.buffers()):
                if id(t) not in experts:
                    collective.broadcast(t.data, src=0, group=g)
        tracked = [p for p in layers.parameters() if p.requires_grad]
        self._reducer = _BucketReducer(tracked, comm_buffer_mb=comm_buffer_size, group=g,
                                       names={id(p): n for n, p in layers.named_parameters()})
        self._pending = set()
        self._queued = False
        ref = weakref.ref(self)

        def flush():
            dp = ref()
            if dp is None:
                return
            dp._queued = False
            if not dp._sync_enabled or not dp._pending:
                return
            dp._pending.clear()
            dp._reducer.reduce(dp.find_unused_parameters)

        def hook(p):
            dp = ref()
            if dp is None:
                return
            dp._pending.add(id(p))
            if not dp._queued:  # the first gradient of this pass queues the flush
                dp._queued = True
                torch.autograd.Variable._execution_engine.queue_callback(flush)

        for p in tracked:
            self._hook_handles.append(p.register_post_accumulate_grad_hook(hook))

    def forward(self, *inputs, **kwargs):
        """The wrapped layers' forward; above one rank in a random scope
        with the rank folded into the current stream's next key, so the
        ranks' dropout masks differ (drawn only if something draws)."""
        if self._rank is None:
            return self._layers(*inputs, **kwargs)
        with _random.fold_scope(self._rank):
            return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss  # the reducer divides by the group size

    def apply_collective_grads(self):
        """All-reduce every ``.grad`` now (after ``no_sync()`` accumulation)."""
        if self._grad_sync:
            self._reducer.reduce(find_unused_parameters=True)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.load_state_dict(*args, **kwargs)

    load_state_dict = set_state_dict

    @contextlib.contextmanager
    def no_sync(self):
        """Skip the gradient averaging inside the context (accumulation)."""
        prev = self._sync_enabled
        self._sync_enabled = False
        try:
            yield
        finally:
            self._sync_enabled = prev


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Parity: paddle.distributed.spawn. ``nprocs`` of -1, 0 or 1 is a direct
    call; above 1, each rank is a spawned process (``torch.multiprocessing``)
    with the ``PADDLE_*`` rendezvous environment (master from
    ``options["master"]`` or a free local port) that runs ``func(*args)``.
    Returns None after joining, or (``join=False``) a context whose
    ``join()`` waits and raises if a rank failed."""
    if nprocs in (-1, 0, 1):
        func(*args)
        return None
    import torch.multiprocessing as mp

    master = options.get("master") or f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawn_worker, args=(func, args, rank, nprocs, master),
                         daemon=daemon) for rank in range(nprocs)]
    for p in procs:
        p.start()

    class _Ctx:
        processes = procs

        @staticmethod
        def join(timeout=None):
            rc = 0
            for p in procs:
                p.join(timeout)
                if p.exitcode:
                    rc = p.exitcode
            if rc:
                raise RuntimeError(f"spawn: a worker exited with code {rc}")
            return True

    if join:
        _Ctx.join()
        return None
    return _Ctx()


def _spawn_worker(func, args, rank, world, master):
    os.environ.update({"PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
                       "PADDLE_MASTER": master, "PADDLE_LOCAL_RANK": str(rank)})
    func(*args)

