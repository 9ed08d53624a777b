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


def _contexts(saved_ops, replay):
    """The ``(forward, recompute)`` context pair of one checkpointed call:
    the MoE routing replay of ``replay``, with the selective-checkpoint pair
    where ``saved_ops`` names ops to save."""
    fwd, rec = routing_replay(replay)
    if not saved_ops:
        return fwd, rec
    sac_fwd, sac_rec = create_selective_checkpoint_contexts(list(saved_ops))
    return _entered(fwd, sac_fwd), _entered(rec, sac_rec)


def recompute(function, *args, policy="nothing_saveable", replay=None, **kwargs):
    """``function(*args, **kwargs)`` whose activations are recomputed in the
    backward, saving only what ``policy`` names (see the module's doc).
    ``replay``: the module whose MoE layers' routing the recompute replays
    (default: ``function`` when it is an ``nn.Module``). Without grad mode
    it simply calls through."""
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
