"""Collectives of the port (``paddle_tpu/distributed/collective.py``;
parity: python/paddle/distributed/collective.py, all_reduce:618,
all_gather:840, alltoall:1769, broadcast:533).

The reference's are traced ``jax.lax`` collectives inside ``shard_map``
over a mesh axis. The port's are eager ``torch.distributed`` calls over a
process group, one process per rank, computing what the reference's
compute for the rank at that axis index:

- ``group`` is a :class:`Group` (one of the topology's or
  :func:`new_group`'s), an axis name (``"dp"``, ``"mp"``, ...) resolved
  through the active ``fleet``, or None: the fleet's ``dp`` group, as the
  reference defaults to its ``dp`` axis, or the whole world when no fleet
  is initialised;
- ranks inside a group (``src``, ``dst``, ``ppermute``'s pairs) are group
  indices, the reference's axis indices;
- a collective whose reference form returns a value writes the result into
  the tensor it was given, where the shape allows, and returns it;
- ``sync_op`` is taken for the signature: every call completes on the
  issuing stream before it returns, as the reference's do in program order.

Each collective bumps ``collective.<name>.calls`` and runs under a
``collective.<name>`` span. ``AVG`` is a sum divided by the group size
(``jax.lax.pmean``'s arithmetic).

``send``, ``recv`` and :func:`p2p` (several of them posted together, the
pipeline's exchanges) are point-to-point; the reference has none (its
pipeline moves activations by ``ppermute`` inside one program), so they
follow Paddle's and torch's signatures, with group indices for ranks.

Transport: NCCL refuses two ranks on one device, so a world above one on a
single card runs over gloo, which takes CUDA tensors for all-reduce,
all-gather and broadcast but not for point-to-point traffic, all-to-all
nor reduce-scatter. For those (and only under gloo) the collective layer
stages a CUDA tensor through pinned host memory: copy out, the gloo call
on the host copy, copy back. It counts the bytes it stages in
``collective.host_staged_bytes``. Every computation stays on the card;
only the transport passes through the host. Under NCCL nothing is staged.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..observability import metrics
from ..observability.spans import span

__all__ = ["ReduceOp", "Group", "all_reduce", "all_gather", "all_gather_concat", "reduce_scatter",
           "alltoall", "all_to_all", "broadcast", "reduce", "scatter", "ppermute", "send", "recv",
           "p2p", "barrier", "get_group", "new_group", "wait"]

HOST_STAGED = "collective.host_staged_bytes"


def _collective(name):
    """Every entry bumps ``collective.<name>.calls`` and runs under the span
    ``collective.<name>``."""

    def deco(fn):
        counter, span_name = f"collective.{name}.calls", f"collective.{name}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            metrics.counter_inc(counter)
            with span(span_name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN", ReduceOp.AVG: "SUM"}


class Group:
    """A process group: its global ``ranks`` in group order, this process's
    index in it (``rank``, -1 outside it), its size (``nranks``) and the
    ``torch.distributed`` group (``process_group``)."""

    def __init__(self, ranks, process_group, axis_name=None):
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.process_group = process_group
        self.axis_name = axis_name
        me = dist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    def get_global_rank(self, group_rank):
        return self.ranks[group_rank]

    def __repr__(self):
        return f"Group(axis={self.axis_name!r}, ranks={self.ranks}, rank={self.rank})"


_WORLD = {}


def _world_group():
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_parallel_env() or fleet.init() first")
    n = dist.get_world_size()
    if n not in _WORLD:
        _WORLD.clear()
        _WORLD[n] = Group(range(n), dist.group.WORLD, axis_name=None)
    return _WORLD[n]


def _group(group) -> Group:
    if isinstance(group, Group):
        return group
    from .fleet import fleet

    hcg = fleet.get_hybrid_communicate_group()
    if group is None:
        return hcg.group("dp") if hcg is not None else _world_group()
    if isinstance(group, str):
        if hcg is None:
            raise RuntimeError(f"group {group!r} names a fleet axis, but no fleet is "
                               "initialised: call fleet.init(strategy=...) first")
        return hcg.group(group)
    raise TypeError(f"group must be a Group, an axis name or None, got {type(group).__name__}")


def _staged(tensor, g):
    """Whether ``tensor`` goes through pinned host memory on ``g``: a CUDA
    tensor under gloo."""
    return tensor.is_cuda and dist.get_backend(g.process_group) == "gloo"


def _to_host(tensor):
    """A pinned host copy of ``tensor`` (counted in ``HOST_STAGED``)."""
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    metrics.counter_inc(HOST_STAGED, tensor.numel() * tensor.element_size())
    return host


def _host_buffer(tensor):
    metrics.counter_inc(HOST_STAGED, tensor.numel() * tensor.element_size())
    return torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)


def _check_op(op):
    if op not in _TORCH_OP:
        raise ValueError(f"unsupported reduce op {op}")
    return getattr(dist.ReduceOp, _TORCH_OP[op])


@_collective("all_reduce")
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group in place (SUM, MAX, MIN or AVG);
    returns it."""
    g = _group(group)
    dist.all_reduce(tensor, op=_check_op(op), group=g.process_group)
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def _gather_parts(tensor, g):
    parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
    dist.all_gather(parts, tensor.contiguous(), group=g.process_group)
    return parts


@_collective("all_gather")
def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor``. Given a list, fills it with the group's
    tensors in group order and returns it; given a tensor alone (as
    ``tensor_list``), returns them stacked along a new dim ``axis``."""
    g = _group(group)
    if isinstance(tensor_list, list):
        parts = _gather_parts(tensor, g)
        tensor_list.clear()
        tensor_list.extend(parts)
        return tensor_list
    x = tensor_list if tensor is None else tensor
    return torch.stack(_gather_parts(x, g), dim=axis)


@_collective("all_gather_concat")
def all_gather_concat(x, group=None, concat_axis=0):
    """Every rank's ``x`` concatenated along ``concat_axis`` in group order."""
    return torch.cat(_gather_parts(x, _group(group)), dim=concat_axis)


@_collective("reduce_scatter")
def reduce_scatter(output, input, op=ReduceOp.SUM, group=None, sync_op=True, scatter_axis=0):
    """Sum ``input`` over the group and give rank i the i-th of its
    ``nranks`` equal blocks along ``scatter_axis``; written into ``output``
    when it is a tensor, and returned."""
    g = _group(group)
    n = g.nranks
    if input.shape[scatter_axis] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_axis} of size {input.shape[scatter_axis]} "
                         f"does not split over {n} ranks")
    x = input.movedim(scatter_axis, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    if _staged(x, g):
        host_out = _host_buffer(out)
        dist.reduce_scatter_tensor(host_out, _to_host(x), op=_check_op(op), group=g.process_group)
        out.copy_(host_out)
    else:
        dist.reduce_scatter_tensor(out, x, op=_check_op(op), group=g.process_group)
    if op == ReduceOp.AVG:
        out.div_(n)
    out = out.movedim(0, scatter_axis)
    if isinstance(output, torch.Tensor):
        output.copy_(out)
        return output
    return out


def _all_to_all_single(x, g, in_splits=None, out_splits=None):
    """Rows of ``x``'s dim 0 to each rank of ``g`` (``in_splits[j]`` rows to
    rank j, or equal blocks), and the rows received, in group order, along
    dim 0 (``out_splits[j]`` from rank j, or equal blocks)."""
    x = x.contiguous()
    rows = x.shape[0] if out_splits is None else int(sum(out_splits))
    out = x.new_empty((rows, *x.shape[1:]))
    if _staged(x, g):
        host_out = _host_buffer(out)
        dist.all_to_all_single(host_out, _to_host(x), out_splits, in_splits,
                               group=g.process_group)
        out.copy_(host_out)
    else:
        dist.all_to_all_single(out, x, out_splits, in_splits, group=g.process_group)
    return out


def _all_to_all_dim0(x, g):
    """Block j of ``x``'s dim 0 to rank j; the blocks received, in group
    order, along dim 0."""
    return _all_to_all_single(x, g)


@_collective("alltoall")
def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True, split_axis=0,
             concat_axis=0):
    """List form: rank i's ``in_tensor_list[j]`` goes to rank j, which
    receives one tensor from each rank in group order (into
    ``out_tensor_list`` if given, else stacked). Tensor form (tiled): the
    tensor's ``nranks`` blocks along ``split_axis`` go one to each rank,
    and the blocks received are concatenated along ``concat_axis``."""
    g = _group(group)
    n = g.nranks
    if isinstance(in_tensor_list, (list, tuple)):
        out = _all_to_all_dim0(torch.stack(list(in_tensor_list)), g)
        if out_tensor_list is not None:
            out_tensor_list.clear()
            out_tensor_list.extend(out.unbind(0))
            return out_tensor_list
        return out
    x = in_tensor_list
    if x.shape[split_axis] % n:
        raise ValueError(f"alltoall: dim {split_axis} of size {x.shape[split_axis]} does not "
                         f"split over {n} ranks")
    blocks = x.movedim(split_axis, 0)
    recv = _all_to_all_dim0(blocks, g)  # [n * c, ...] in sender order
    recv = recv.reshape(n, recv.shape[0] // n, *recv.shape[1:]).movedim(1, split_axis + 1)
    return torch.cat(recv.unbind(0), dim=concat_axis)


all_to_all = alltoall


@_collective("broadcast")
def broadcast(tensor, src=0, group=None, sync_op=True):
    """The group's rank ``src``'s ``tensor`` on every rank, in place."""
    g = _group(group)
    dist.broadcast(tensor, src=g.get_global_rank(src), group=g.process_group)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Every rank gets the reduction, as the reference's does (:141-143);
    ``dst`` may simply use it."""
    return all_reduce(tensor, op=op, group=group)


@_collective("scatter")
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i gets block i of rank ``src``'s ``tensor_list`` (or of its
    ``tensor`` stacked ``[nranks, ...]`` when no list is given). Every rank
    passes blocks of the same shapes, as the reference's traced ranks do.
    With a list, the block lands in ``tensor``."""
    g = _group(group)
    stacked = torch.stack(list(tensor_list)) if tensor_list is not None else tensor.clone()
    dist.broadcast(stacked, src=g.get_global_rank(src), group=g.process_group)
    out = stacked[g.rank]
    if tensor_list is not None and isinstance(tensor, torch.Tensor):
        tensor.copy_(out)
        return tensor
    return out


@_collective("ppermute")
def ppermute(x, perm, group=None):
    """``jax.lax.ppermute``: for each ``(src, dst)`` pair of group indices,
    ``src``'s ``x`` lands on ``dst``; a rank that no pair sends to gets
    zeros. One ``batch_isend_irecv`` over this rank's pairs."""
    g = _group(group)
    me = g.rank
    out = torch.zeros_like(x)
    x = x.contiguous()
    sends, recvs = [], []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            sends.append((x, dst))
        elif dst == me:
            recvs.append((out, src))
    _post(sends, recvs, g)
    return out


def _post(sends, recvs, g):
    """Post every ``(tensor, dst)`` send and ``(tensor, src)`` receive of
    ``g`` together and wait for them; a CUDA tensor under gloo goes through
    pinned host memory."""
    staged = [(t, _host_buffer(t)) for t, _ in recvs if _staged(t, g)]
    host = {id(t): h for t, h in staged}
    ops = [dist.P2POp(dist.isend, _to_host(t) if _staged(t, g) else t.contiguous(),
                      g.get_global_rank(dst), g.process_group) for t, dst in sends]
    ops += [dist.P2POp(dist.irecv, host.get(id(t), t), g.get_global_rank(src), g.process_group)
            for t, src in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, h in staged:
        t.copy_(h)


def p2p(sends=(), recvs=(), group=None):
    """Post every ``(tensor, dst)`` of ``sends`` and every ``(tensor, src)``
    of ``recvs`` together (``dst``/``src`` group indices) and wait for them
    all; each received tensor is written in place. Posting a pipeline's
    send and receive as one batch is what keeps neighbouring stages that
    both send first from waiting on each other."""
    g = _group(group)
    for _ in sends:
        metrics.counter_inc("collective.send.calls")
    for _ in recvs:
        metrics.counter_inc("collective.recv.calls")
    if sends or recvs:
        with span("collective.p2p"):
            _post(sends, recvs, g)


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to the group's rank ``dst``; blocks until it is
    delivered."""
    p2p(sends=[(tensor, dst)], group=group)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from the group's rank ``src``; returns it."""
    p2p(recvs=[(tensor, src)], group=group)
    return tensor


@_collective("barrier")
def barrier(group=None):
    g = _group(group)
    dist.barrier(group=g.process_group)


def get_group(name="dp") -> Group:
    """The active fleet's group along the axis ``name``."""
    return _group(name)


def new_group(ranks=None, backend=None, timeout=None, axis_name=None) -> Group:
    """A group of the global ``ranks`` (every rank by default). Every rank
    of the world calls it, members or not, in the same order."""
    ranks = list(range(dist.get_world_size())) if ranks is None else sorted(int(r) for r in ranks)
    kw = {} if timeout is None else {"timeout": timeout}
    return Group(ranks, dist.new_group(ranks, backend=backend, **kw), axis_name=axis_name)


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until ``tensor``'s stream has finished its work."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor
