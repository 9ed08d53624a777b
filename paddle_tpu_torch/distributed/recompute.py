"""Activation recompute (``paddle_tpu/distributed/recompute.py``).

The reference wraps a function in ``jax.checkpoint`` with a saving policy;
here it is ``torch.utils.checkpoint.checkpoint`` in its non-reentrant form,
whose side outputs (a MoE layer's aux loss, read after the forward) stay in
the autograd graph. The policies keep the reference's names:

- ``nothing_saveable``: save nothing inside the block, recompute it all;
- ``dots_saveable``: save the outputs of the matmuls (``aten.mm``,
  ``addmm``, ``bmm``, ``baddbmm``) and recompute the rest;
- ``dots_with_no_batch_dims_saveable``: save ``mm`` and ``addmm`` only.

A kernel launched from an ``autograd.Function`` (the flash kernels) is no
aten op: no policy can save its output, so its forward runs again in the
recompute, as a Pallas call does under the reference's ``dots_saveable``.

``torch.utils.checkpoint`` replays only the global CPU and CUDA random
states; a GShard MoE layer draws its jitter from a generator it owns. The
recompute therefore replays each such layer's routing
(:func:`paddle_tpu_torch.distributed.moe.routing_replay`) in the module
given as ``replay`` (by default ``function`` itself, when it is a module).

The recompute runs ``forward`` again, and with it every in-place update a
forward makes to a buffer (BatchNorm's running statistics). The
reference's buffers are functional outputs of the one forward, so they
move once per step; here :func:`buffer_replay` gives the recompute the
buffers the forward started from and then puts back the ones it left.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from .moe import routing_replay

_MM = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
_BATCHED_MM = [torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default]

# policy name -> the aten ops whose outputs are saved; "none" is no policy,
# which in jax.checkpoint (and so here) saves nothing
POLICIES = {
    "none": (),
    "nothing_saveable": (),
    "dots_saveable": tuple(_MM + _BATCHED_MM),
    "dots_with_no_batch_dims_saveable": tuple(_MM),
}


def _policy(policy):
    """The saved ops of a policy name; an unknown name raises instead of
    silently degrading to full recompute."""
    if policy not in POLICIES:
        raise ValueError(f"unknown recompute policy {policy!r}; expected one of {sorted(POLICIES)}")
    return POLICIES[policy]


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def buffer_replay(module):
    """The ``(forward, recompute)`` context pair that keeps a recompute from
    moving the buffers of ``module`` (None: no buffer). The forward context
    copies every buffer before the forward and, after it, keeps the
    buffers the forward changed in place (by their version counters) with
    their values before and after. The recompute context sets those buffers
    to their values before the forward, so the recompute sees what the
    forward saw, and on leaving (also when the checkpoint stops the
    recompute early) to their values after it: each buffer moves once per
    step, as without recompute."""
    buffers = [] if module is None else list(module.buffers())
    changed = []

    @contextlib.contextmanager
    def forward():
        versions = [b._version for b in buffers]
        before = [b.clone() for b in buffers]
        try:
            yield
        finally:
            changed[:] = [(b, old, b.clone()) for b, v, old in zip(buffers, versions, before)
                          if b._version != v]

    @contextlib.contextmanager
    def recompute():
        with torch.no_grad():
            for b, old, _ in changed:
                b.copy_(old)
        try:
            yield
        finally:
            with torch.no_grad():
                for b, _, new in changed:
                    b.copy_(new)

    return forward(), recompute()


def _contexts(saved_ops, replay):
    """The ``(forward, recompute)`` context pair of one checkpointed call:
    the MoE routing replay and the buffer replay of ``replay``, with the
    selective-checkpoint pair where ``saved_ops`` names ops to save."""
    route_fwd, route_rec = routing_replay(replay)
    buf_fwd, buf_rec = buffer_replay(replay)
    if not saved_ops:
        return _entered(route_fwd, buf_fwd), _entered(route_rec, buf_rec)
    sac_fwd, sac_rec = create_selective_checkpoint_contexts(list(saved_ops))
    return _entered(route_fwd, buf_fwd, sac_fwd), _entered(route_rec, buf_rec, sac_rec)


def recompute(function, *args, policy="nothing_saveable", replay=None, **kwargs):
    """``function(*args, **kwargs)`` whose activations are recomputed in the
    backward, saving only what ``policy`` names (see the module's doc).
    ``replay``: the module whose MoE layers' routing and buffers the
    recompute replays (default: ``function`` when it is an
    ``nn.Module``). Without grad mode it simply calls through."""
    saved_ops = _policy(policy)
    if replay is None and isinstance(function, nn.Module):
        replay = function
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    return checkpoint(function, *args, use_reentrant=False,
                      context_fn=functools.partial(_contexts, saved_ops, replay), **kwargs)


def remat(fn, policy="nothing_saveable"):
    """``fn`` wrapped so that each call goes through :func:`recompute`."""
    _policy(policy)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return recompute(fn, *args, policy=policy, **kwargs)

    return wrapped
