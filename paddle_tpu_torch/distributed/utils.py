"""Helpers of the port's distributed layer (``paddle_tpu/distributed/utils.py``):
the host name and address, free local ports, a console logger, and the
expert exchange of a mixture of experts, ``global_scatter`` and
``global_gather``.

The exchange keeps Paddle's count contract (``global_scatter_op.cu.cc``):
over a group of ``n`` ranks holding ``ne`` experts each, ``local_count[j *
ne + i]`` rows of ``x`` go to expert i of rank j, and ``global_count[j * ne
+ i]`` rows come from rank j for this rank's expert i. ``global_scatter``
takes rows in the order of ``local_count`` (by global expert id, each
destination rank's block in turn) and returns the rows received ordered by
local expert, each expert's rows in the order of the ranks that sent them;
``global_gather`` is its inverse. The rows must number the counts' sum, or
they raise ``ValueError``. The reference runs one process over a mesh and
raises ``NotImplementedError`` where the counts cross ranks; the port runs
one process per rank and performs the exchange: one ``all_to_all_single``
with split sizes over the group, staged through pinned host memory for a
CUDA tensor under gloo and on the device under NCCL, counted in
``collective.global_scatter.calls`` and ``collective.global_gather.calls``.
Both are differentiable: each one's backward is the other. In a world of
one the counts must agree and the rows pass through.

The reference's legacy launch bookkeeping (``Trainer``, ``Pod``,
``Cluster``, ``get_cluster``, ``start_local_trainers`` and their helpers)
has no counterpart: the port's launcher (:mod:`.launch`) starts and
watches its workers itself, and nothing else calls them.
"""
from __future__ import annotations

import logging
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .collective import _all_to_all_single, _collective


def get_host_name_ip():
    """``(host name, its IPv4 address)``, or ``(None, None)``."""
    try:
        name = socket.gethostname()
        return name, socket.gethostbyname(name)
    except OSError:
        return None, None


def find_free_ports(num: int) -> Optional[set]:
    """``num`` distinct TCP ports free on this host (all held open until
    every one is found, so they differ)."""
    out = set()
    socks = []
    try:
        for _ in range(num):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("", 0))
            socks.append(s)
            out.add(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return out


def get_logger(log_level=20, name="root"):
    """The logger ``name`` at ``log_level``, with one stream handler."""
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(levelname)s %(asctime)s %(message)s"))
        logger.addHandler(h)
    return logger


# -- the expert exchange ---------------------------------------------------------


def _counts(c):
    if isinstance(c, torch.Tensor):
        return [int(v) for v in c.reshape(-1).tolist()]
    return [int(v) for v in np.asarray(c).reshape(-1)]


def _exchange_group(group):
    """The group of an exchange, or None in a world of one."""
    from . import collective

    if group is None and not dist.is_initialized():
        return None
    g = collective._group(group)
    return g if g.nranks > 1 else None


def _expert_major(gc, n, device):
    """Row q of the expert-major layout (local expert i, then the sending
    rank j) is row ``idx[q]`` of the rank-major one that
    ``all_to_all_single`` receives, for the block sizes ``gc[j * ne + i]``."""
    c = torch.tensor(gc, dtype=torch.long).reshape(n, -1)
    flat = c.reshape(-1)
    rank_major_start = (torch.cumsum(flat, 0) - flat).reshape(c.shape)
    lens = c.t().reshape(-1)
    starts = rank_major_start.t().reshape(-1)
    out_start = torch.cumsum(lens, 0) - lens
    idx = torch.repeat_interleave(starts - out_start, lens) + torch.arange(int(lens.sum()))
    return idx.to(device)


def _per_rank(counts, n):
    """The rows of each of the n ranks' blocks of ``counts``."""
    ne = len(counts) // n
    return [sum(counts[j * ne:(j + 1) * ne]) for j in range(n)]


@_collective("global_scatter")
def _scatter_rows(x, lc, gc, g):
    recv = _all_to_all_single(x, g, _per_rank(lc, g.nranks), _per_rank(gc, g.nranks))
    return recv.index_select(0, _expert_major(gc, g.nranks, x.device))


@_collective("global_gather")
def _gather_rows(y, lc, gc, g):
    idx = _expert_major(gc, g.nranks, y.device)
    rank_major = torch.empty_like(y).index_copy_(0, idx, y)
    return _all_to_all_single(rank_major, g, _per_rank(gc, g.nranks), _per_rank(lc, g.nranks))


class _GlobalScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lc, gc, g):
        ctx.args = (lc, gc, g)
        return _scatter_rows(x, lc, gc, g)

    @staticmethod
    def backward(ctx, dy):
        return _gather_rows(dy.contiguous(), *ctx.args), None, None, None


class _GlobalGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, lc, gc, g):
        ctx.args = (lc, gc, g)
        return _gather_rows(y, lc, gc, g)

    @staticmethod
    def backward(ctx, dx):
        return _scatter_rows(dx.contiguous(), *ctx.args), None, None, None


def _global_exchange(x, local_count, global_count, group, gather):
    lc, gc = _counts(local_count), _counts(global_count)
    rows, send, recv = x.shape[0], sum(lc), sum(gc)
    if len(lc) != len(gc) or (gather and rows != recv) or (not gather and rows != send):
        raise ValueError(f"count mismatch: rows={rows}, local={send}, global={recv} "
                         f"({len(lc)} and {len(gc)} counts)")
    g = _exchange_group(group)
    if g is None:
        if lc != gc:
            raise ValueError(f"count mismatch: in a world of one the local counts {lc} and the "
                             f"global counts {gc} must agree")
        return x
    if len(lc) % g.nranks:
        raise ValueError(f"{len(lc)} counts do not split over a group of {g.nranks} ranks")
    fn = _GlobalGather if gather else _GlobalScatter
    return fn.apply(x, tuple(lc), tuple(gc), g)


def global_scatter(x, local_count, global_count, group=None, use_calc_stream=True):
    """Send ``local_count[j * ne + i]`` rows of ``x`` (ordered by global
    expert id) to expert i of rank j; returns the ``sum(global_count)`` rows
    received, ordered by local expert and, within one, by sending rank."""
    return _global_exchange(x, local_count, global_count, group, gather=False)


def global_gather(x, local_count, global_count, group=None, use_calc_stream=True):
    """:func:`global_scatter`'s inverse: the expert-major rows ``x`` go back
    to the ranks they came from, which receive them in their sending
    order."""
    return _global_exchange(x, local_count, global_count, group, gather=True)
