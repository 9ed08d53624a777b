"""Pooling functionals of the port (``paddle_tpu/nn/functional/pooling.py``).

The reference pools with ``lax.reduce_window``, no Pallas kernel, so here
they are ``torch.nn.functional``'s pools. The reference drops
``ceil_mode``, ``data_format``, ``divisor_override`` and ``return_mask``
without a word (``max_pool2d`` and ``avg_pool2d`` there); the port raises on
each instead (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import torch.nn.functional as F


def _pair(v, n, what):
    p = [int(x) for x in v] if isinstance(v, (list, tuple)) else [int(v)] * n
    if len(p) != n:
        raise ValueError(f"{what} must be an int or {n} ints, got {v!r}")
    return p


def _window(kernel_size, stride, padding):
    ks = _pair(kernel_size, 2, "kernel_size")
    return ks, (ks if stride is None else _pair(stride, 2, "stride")), _pair(padding, 2, "padding")


def _refuse(name, data_format="NCHW", ceil_mode=False, **unported):
    if data_format != "NCHW":
        raise NotImplementedError(f"{name}: data_format={data_format!r} is not ported, only 'NCHW'")
    for knob, value in dict(unported, ceil_mode=ceil_mode).items():
        if value:
            raise NotImplementedError(f"{name}: {knob}={value!r} is not ported")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    """Max over each window; the padding counts as -inf, so it never wins.
    ``stride`` None is the kernel size."""
    _refuse("max_pool2d", data_format, ceil_mode, return_mask=return_mask)
    ks, st, pd = _window(kernel_size, stride, padding)
    return F.max_pool2d(x, ks, st, pd)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    """Mean over each window; ``exclusive`` (the default) leaves the padding
    out of the count, else every window divides by the kernel's size."""
    _refuse("avg_pool2d", data_format, ceil_mode, divisor_override=divisor_override)
    ks, st, pd = _window(kernel_size, stride, padding)
    return F.avg_pool2d(x, ks, st, pd, count_include_pad=not exclusive)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the windows ``[floor(i in / out), ceil((i + 1) in / out))``
    of each spatial dim (the reference's ``_adaptive_pool``); an
    ``output_size`` entry of None keeps that dim."""
    _refuse("adaptive_avg_pool2d", data_format)
    return F.adaptive_avg_pool2d(x, output_size)
