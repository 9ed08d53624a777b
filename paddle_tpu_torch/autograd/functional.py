"""Functional autograd: ``vjp``, ``jvp``, ``jacobian``, ``hessian``
(``paddle_tpu/autograd/functional.py``; parity:
python/paddle/autograd/functional.py), over
``torch.autograd.functional``.

Functions take and return tensors in the reference's layouts
(``functional.py:72-125``): ``jacobian`` gives, for one input and one
output, the ``(out.numel(), in.numel())`` matrix, and nested tuples
``J[i][j]`` over (output i, input j) otherwise; ``hessian`` of a function
whose output is summed to a scalar gives ``(n, n)``, or ``H[i][j]`` over
pairs of inputs. Results are detached unless ``create_graph``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd import functional as F

__all__ = ["vjp", "jvp", "jacobian", "hessian"]


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _inputs(xs):
    return tuple(x.detach() for x in _as_list(xs))


def vjp(func: Callable, xs, v=None):
    """``(func(xs), the gradients of sum(out * v) with respect to xs)``;
    ``v`` defaults to ones. One gradient alone, else a list."""
    ins = _inputs(xs)
    probe = func(*ins)
    multi = isinstance(probe, (tuple, list))
    cot = None if v is None else (tuple(_as_list(v)) if multi else _as_list(v)[0])
    if cot is None:
        cot = tuple(torch.ones_like(o) for o in probe) if multi else torch.ones_like(probe)
    out, grads = F.vjp(func, ins, cot)
    grads = list(grads)
    return (tuple(out) if multi else out), (grads if len(grads) > 1 else grads[0])


def jvp(func: Callable, xs, v=None):
    """``(func(xs), J v)``; ``v`` defaults to ones."""
    ins = _inputs(xs)
    tangents = tuple(torch.ones_like(x) for x in ins) if v is None else tuple(_as_list(v))
    out, tang = F.jvp(func, ins, tangents)
    if isinstance(out, (tuple, list)):
        return tuple(out), tuple(tang)
    return out, tang


def _flat(block, rows, cols):
    return block.reshape(max(rows, 1), max(cols, 1))


def jacobian(func: Callable, xs, create_graph: bool = False, allow_unused: bool = False):
    """The flattened 2-D Jacobian (see the module's docstring)."""
    ins = _inputs(xs)
    out = func(*ins)
    multi_out = isinstance(out, (tuple, list))
    outs = list(out) if multi_out else [out]
    jac = F.jacobian(func, ins, create_graph=create_graph, strict=False)
    per_out = list(jac) if multi_out else [jac]
    rows = []
    for o, jrow in zip(outs, per_out):
        blocks = [_flat(b, o.numel(), a.numel()) for b, a in zip(jrow, ins)]
        rows.append(tuple(blocks) if len(blocks) > 1 else blocks[0])
    return tuple(rows) if multi_out else rows[0]


def hessian(func: Callable, xs, create_graph: bool = False, allow_unused: bool = False):
    """The flattened Hessian of ``sum(func(xs))`` (see the module's
    docstring)."""
    ins = _inputs(xs)

    def scalar_fn(*a):
        out = func(*a)
        if isinstance(out, (tuple, list)):
            raise ValueError("hessian requires a scalar-output function")
        return torch.sum(out)

    h = F.hessian(scalar_fn, ins, create_graph=create_graph, strict=False)
    if len(ins) == 1:
        n = ins[0].numel()
        return _flat(h[0][0], n, n)
    return tuple(tuple(_flat(h[i][j], ins[i].numel(), ins[j].numel()) for j in range(len(ins)))
                 for i in range(len(ins)))
