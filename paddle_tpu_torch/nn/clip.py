"""Gradient clipping of the port (``paddle_tpu/nn/clip.py``): by value, by
each gradient's norm, by the global norm, and torch's ``clip_grad_norm_``.

Each clip's ``apply_list(grads)`` returns the clipped gradients as new
tensors, in their own dtypes, as the optimizers use it. Norms are taken in
f32.

Under tensor parallelism a norm is the whole parameters', as the
reference takes it over its unsharded arrays: given ``params`` (the
gradients' parameters), the terms of the shards of ``is_distributed``
parameters (those with an ``mp_group``) are all-reduced over their model-parallel group, and each
replicated parameter, which every rank of the group holds whole, counts
once."""
from __future__ import annotations

import torch


def _shard_groups(params):
    """Each parameter's model-parallel group if it is a shard, else None;
    None when no parameter is a shard."""
    if params is None:
        return None
    groups = [getattr(p, "mp_group", None) for p in params]
    return groups if any(g is not None for g in groups) else None


def _reduce_terms(terms, groups, op="sum"):
    """The sum (or max) of per-parameter ``terms``, those of shards reduced
    over their groups first."""
    combine = (lambda ts: sum(ts)) if op == "sum" else (lambda ts: torch.stack(ts).max())
    if groups is None:
        return combine(terms)
    from ..distributed import collective

    whole = [t for t, g in zip(terms, groups) if g is None]
    by_group = {}
    for t, g in zip(terms, groups):
        if g is not None:
            by_group.setdefault(id(g), (g, []))[1].append(t)
    for g, ts in by_group.values():
        part = combine(ts).clone()
        collective.all_reduce(part, op=collective.ReduceOp.SUM if op == "sum"
                              else collective.ReduceOp.MAX, group=g)
        whole.append(part)
    return combine(whole)


class ClipGradByValue:
    """Clamp every gradient element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def apply_list(self, grads, params=None):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm:
    """Scale each gradient by ``min(1, clip_norm / max(its norm, 1e-12))``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply_list(self, grads, params=None):
        groups = _shard_groups(params)
        out = []
        for i, g in enumerate(grads):
            sq = g.float().square().sum()
            if groups is not None:
                sq = _reduce_terms([sq], [groups[i]])
            norm = torch.sqrt(sq)
            scale = (self.clip_norm / norm.clamp(min=1e-12)).clamp(max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / max(norm, 1e-12))``, the
    norm taken in f32 over all of them.

    A non-finite global norm makes the scale non-finite, so every clipped
    gradient PROPAGATES as NaN, as in the reference: the clip never hides a
    blown-up step by scaling it down."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = clip_norm

    def apply_list(self, grads, params=None):
        total = _reduce_terms([g.float().square().sum() for g in grads], _shard_groups(params))
        scale = (self.clip_norm / torch.sqrt(total).clamp(min=1e-12)).clamp(max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so their total norm
    of order ``norm_type`` is at most ``max_norm``; returns the norm (an f32
    tensor), or None when no parameter has a gradient.

    ``error_if_nonfinite=True`` raises ``RuntimeError`` on a NaN or Inf
    norm before touching a gradient; otherwise the norm flows through the
    scale as in torch: a NaN norm makes every gradient NaN, an Inf norm
    scales them to 0."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return None
    norm_type = float(norm_type)
    groups = _shard_groups(params)
    if norm_type == float("inf"):
        gnorm = _reduce_terms([p.grad.float().abs().max() for p in params], groups, op="max")
    elif norm_type == 2.0:
        gnorm = torch.sqrt(_reduce_terms([p.grad.float().square().sum() for p in params], groups))
    else:
        gnorm = _reduce_terms([(p.grad.float().abs() ** norm_type).sum() for p in params],
                              groups) ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(gnorm)):
        raise RuntimeError(
            f"The total norm of order {norm_type} for gradients from "
            "`parameters` is non-finite, so it cannot be clipped. To disable "
            "this error and scale the gradients by the non-finite norm "
            "anyway, set `error_if_nonfinite=False`")
    scale = (max_norm / gnorm.clamp(min=1e-12)).clamp(max=1.0)
    with torch.no_grad():
        for p in params:
            p.grad = (p.grad.float() * scale).to(p.grad.dtype)
    return gnorm
