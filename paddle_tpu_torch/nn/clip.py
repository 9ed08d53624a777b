"""Gradient clipping of the port (``paddle_tpu/nn/clip.py``): by value, by
each gradient's norm, by the global norm, and torch's ``clip_grad_norm_``.

Each clip's ``apply_list(grads)`` returns the clipped gradients as new
tensors, in their own dtypes, as the optimizers use it. Norms are taken in
f32.

Over a sharded model a norm is the whole parameters', as the reference
takes it over its unsharded arrays. Given ``params`` (the gradients'
parameters), each gradient's squares are summed over the groups that hold
the rest of it: its tensor-parallel group (a shard, ``mp_group``), its
ZeRO group (a gradient block, ``zero_group``), its expert group (a
mixture of experts' slice of the experts, ``expert_group``) and, for the
global norm,
its pipeline group (``pp_group``: each stage holds its own layers; the
last stage's copy of a tied table, ``pp_tied_copy``, counts no more). For
one parameter's own norm the pipeline group sums only a stacked trunk's
``[L / pp, ...]`` slice (``stacked_layers``). A replicated parameter,
which every rank of a group holds whole, counts once.
"""
from __future__ import annotations

import torch


def norm_groups(p, whole_param=False):
    """The groups over which the squares of ``p``'s gradient are summed for
    the global norm, or (``whole_param``) for ``p``'s own norm."""
    groups = [getattr(p, "mp_group", None), getattr(p, "zero_group", None),
              getattr(p, "expert_group", None)]
    if not whole_param or getattr(p, "stacked_layers", False):
        groups.append(getattr(p, "pp_group", None))
    return tuple(g for g in groups if g is not None and g.nranks > 1)


def _shard_groups(params, whole_param=False):
    """Each parameter's :func:`norm_groups`, or None (skip its term: a tied
    copy) ; None when no parameter has any."""
    if params is None:
        return None
    groups = [None if not whole_param and getattr(p, "pp_tied_copy", False)
              else norm_groups(p, whole_param) for p in params]
    return groups if any(g != () for g in groups) else None


def _reduce_terms(terms, groups, op="sum"):
    """The sum (or max) of per-parameter ``terms``, each reduced over its
    groups (a tuple; None drops the term) after the terms of one tuple are
    combined."""
    combine = (lambda ts: sum(ts)) if op == "sum" else (lambda ts: torch.stack(ts).max())
    if groups is None:
        return combine(terms)
    from ..distributed import collective

    whole = [t for t, g in zip(terms, groups) if g == ()]
    by_groups = {}
    for t, gs in zip(terms, groups):
        if gs:
            by_groups.setdefault(tuple(id(g) for g in gs), (gs, []))[1].append(t)
    for gs, ts in by_groups.values():
        part = combine(ts).clone()
        for g in gs:
            collective.all_reduce(part, op=collective.ReduceOp.SUM if op == "sum"
                                  else collective.ReduceOp.MAX, group=g)
        whole.append(part)
    if not whole:
        return combine([t.new_zeros(()) for t in terms[:1]])
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
        groups = _shard_groups(params, whole_param=True)
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
