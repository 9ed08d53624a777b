"""Pooling functionals of the port (``paddle_tpu/nn/functional/pooling.py``):
the max and average pools in 1, 2 and 3 dims and their adaptive forms.

The reference pools with ``lax.reduce_window``, no Pallas kernel, so here
they are ``torch.nn.functional``'s pools, with Paddle's semantics:

- ``padding``: an int, one int a dim, two a dim (``[before0, after0,
  ...]``), or ``"SAME"``/``"VALID"``; the padding never wins a max;
- ``ceil_mode``: a dim's output is ``(in + before + after - k + s - 1) // s
  + 1`` long (Paddle's ``PoolOutputSize``), without torch's rule that drops
  a last window starting in the right padding; the max over a window of
  padding only is -inf (its mask -1), and an exclusive mean over one is 0;
- ``exclusive`` (the mean's default) divides by the window's elements
  inside the input, otherwise by the kernel's size; ``divisor_override``
  divides by itself;
- ``return_mask``: each max's flat index (int32) into the input's unpadded
  spatial plane, which ``max_unpool1d/2d/3d`` take;
- a ``data_format`` ending in ``C`` is channel-last, output and mask too.

The reference drops ``ceil_mode``, ``data_format``, ``divisor_override``
and the adaptive pools' ``return_mask`` without a word (ROADMAP.md, "Faults
in the reference").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .conv import _conv_padding

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_ADAPTIVE_AVG = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d, 3: F.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: F.adaptive_max_pool1d, 2: F.adaptive_max_pool2d, 3: F.adaptive_max_pool3d}


def _pair(v, n, what):
    p = [int(x) for x in v] if isinstance(v, (list, tuple)) else [int(v)] * n
    if len(p) != n:
        raise ValueError(f"{what} must be an int or {n} ints, got {v!r}")
    return p


def _first(x, data_format):
    return x.movedim(-1, 1) if data_format.endswith("C") else x


def _back(y, data_format):
    return y.movedim(1, -1) if data_format.endswith("C") else y


def _avg_sum(v, n, ks, st):
    """Each window's sum over ``v`` (padding already in it)."""
    if n == 1:  # avg_pool1d takes no divisor_override
        return F.avg_pool2d(v.unsqueeze(-2), [1] + ks, [1] + st, divisor_override=1).squeeze(-2)
    return (F.avg_pool2d if n == 2 else F.avg_pool3d)(v, ks, st, divisor_override=1)


def _unpadded(idx, padded, left, sizes):
    """Flat indices into a padded spatial plane as flat indices into the
    unpadded one; -1 for a max taken in the padding (a window with no
    input element)."""
    coords, rest = [], idx
    for size in reversed(padded):
        coords.append(rest % size)
        rest = rest // size
    flat, inside = torch.zeros_like(idx), torch.ones_like(idx, dtype=torch.bool)
    for c, a, size in zip(reversed(coords), left, sizes):
        flat = flat * size + (c - a)
        inside &= (c >= a) & (c < a + size)
    return torch.where(inside, flat, -1)


def _pool(x, n, kernel_size, stride, padding, ceil_mode, data_format, maxed, exclusive=True,
          divisor_override=None, return_mask=False):
    v = _first(x, data_format)
    ks = _pair(kernel_size, n, "kernel_size")
    st = ks if stride is None else _pair(stride, n, "stride")
    sizes = list(v.shape[2:])
    pads = _conv_padding(padding, n, sizes, ks, st, [1] * n)
    outs = [(size + a + b - k + (s - 1 if ceil_mode else 0)) // s + 1
            for size, (a, b), k, s in zip(sizes, pads, ks, st)]
    floor = [(size + a + b - k) // s + 1 for size, (a, b), k, s in zip(sizes, pads, ks, st)]
    left = [a for a, _ in pads]
    if outs == floor and all(a == b and 2 * a <= k for (a, b), k in zip(pads, ks)):
        # torch's own padding gives these windows
        if maxed:
            y = _MAX[n](v, ks, st, left, return_indices=return_mask)
        elif n == 1:
            y = F.avg_pool2d(v.unsqueeze(-2), [1] + ks, [1] + st, [0] + left,
                             count_include_pad=not exclusive,
                             divisor_override=divisor_override).squeeze(-2)
        else:
            y = (F.avg_pool2d if n == 2 else F.avg_pool3d)(
                v, ks, st, left, count_include_pad=not exclusive, divisor_override=divisor_override)
    else:
        # pad explicitly: before as given, after as far as the last window reaches
        right = [(o - 1) * s + k - size - a for o, s, k, size, a in zip(outs, st, ks, sizes, left)]
        flat_pads = [p for a, r in reversed(list(zip(left, right))) for p in (a, r)]
        if maxed:
            vp = F.pad(v, flat_pads, value=-math.inf)
            y = _MAX[n](vp, ks, st, return_indices=return_mask)
            if return_mask:
                y = (y[0], _unpadded(y[1], vp.shape[2:], left, sizes))
        else:
            y = _avg_sum(F.pad(v, flat_pads), n, ks, st)
            if divisor_override:
                y = y / divisor_override
            elif not exclusive:
                y = y / math.prod(ks)
            else:
                ones = torch.ones([1, 1] + sizes, dtype=v.dtype, device=v.device)
                y = y / _avg_sum(F.pad(ones, flat_pads), n, ks, st).clamp(min=1)
    if return_mask:
        return _back(y[0], data_format), _back(y[1].to(torch.int32), data_format)
    return _back(y, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               name=None):
    """Max over each window of ``[N, C, L]``; ``stride`` None is the kernel
    size."""
    return _pool(x, 1, kernel_size, stride, padding, ceil_mode, "NCL", True,
                 return_mask=return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    """Max over each window; ``stride`` None is the kernel size."""
    return _pool(x, 2, kernel_size, stride, padding, ceil_mode, data_format, True,
                 return_mask=return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW", name=None):
    return _pool(x, 3, kernel_size, stride, padding, ceil_mode, data_format, True,
                 return_mask=return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False, name=None):
    """Mean over each window of ``[N, C, L]``."""
    return _pool(x, 1, kernel_size, stride, padding, ceil_mode, "NCL", False, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    """Mean over each window; ``exclusive`` (the default) leaves the padding
    out of the count, else every window divides by the kernel's size."""
    return _pool(x, 2, kernel_size, stride, padding, ceil_mode, data_format, False, exclusive,
                 divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    return _pool(x, 3, kernel_size, stride, padding, ceil_mode, data_format, False, exclusive,
                 divisor_override)


def _adaptive(x, n, output_size, data_format, maxed, return_mask=False):
    """Pool over the windows ``[floor(i in / out), ceil((i + 1) in / out))``
    of each spatial dim (the reference's ``_adaptive_pool``); an
    ``output_size`` entry of None keeps that dim."""
    v = _first(x, data_format)
    out = list(output_size) if isinstance(output_size, (list, tuple)) else [output_size] * n
    if len(out) != n:
        raise ValueError(f"output_size must be an int or {n} entries, got {output_size!r}")
    out = [v.shape[2 + i] if o is None else int(o) for i, o in enumerate(out)]
    if not maxed:
        return _back(_ADAPTIVE_AVG[n](v, out), data_format)
    y = _ADAPTIVE_MAX[n](v, out, return_indices=return_mask)
    if return_mask:
        return _back(y[0], data_format), _back(y[1].to(torch.int32), data_format)
    return _back(y, data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, 1, output_size, "NCL", False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, 2, output_size, data_format, False)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, 3, output_size, data_format, False)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 1, output_size, "NCL", True, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 2, output_size, "NCHW", True, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 3, output_size, "NCDHW", True, return_mask)
