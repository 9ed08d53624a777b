"""Convolution functionals of the port (``paddle_tpu/nn/functional/conv.py``).

The reference's convolutions are ``jax.lax.conv_general_dilated``, no Pallas
kernel, so here they are ``torch.nn.functional.conv{1,2,3}d`` (cuDNN on the
card). Channels first only (``NCL``, ``NCHW``, ``NCDHW``); the channel-last
layouts and the transposed convolutions are not ported yet (ROADMAP.md,
Queue 1 item 12).
"""
from __future__ import annotations

import torch.nn.functional as F

from ...amp import cast_inputs

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CHANNELS_FIRST = {1: "NCL", 2: "NCHW", 3: "NCDHW"}


def _pair(v, n):
    return [int(x) for x in v] if isinstance(v, (list, tuple)) else [int(v)] * n


def _conv_padding(padding, n, in_sp, ks, strides, dilations):
    """The ``(before, after)`` padding of each spatial dim, by the
    reference's ``_conv_padding`` rules: ``"SAME"`` (XLA's: the output is
    ``ceil(in / stride)`` long, the odd pad goes after) or ``"VALID"``; an
    int or n ints, each padding both sides; or 2n ints, ``[before0, after0,
    before1, after1, ...]``."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        pads = []
        for size, k, s, d in zip(in_sp, ks, strides, dilations):
            out = -(-size // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    p = _pair(padding, n)
    if len(p) == n:
        return [(x, x) for x in p]
    if len(p) == 2 * n:
        return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    raise ValueError(f"padding must hold 1, {n} or {2 * n} ints, got {padding!r}")


def _convnd(x, weight, bias, stride, padding, dilation, groups, n, data_format):
    x, weight, bias = cast_inputs(f"conv{n}d", x, weight, bias)
    if data_format != _CHANNELS_FIRST[n]:
        raise NotImplementedError(
            f"conv{n}d: data_format={data_format!r} is not ported yet, only "
            f"{_CHANNELS_FIRST[n]!r} (ROADMAP.md, Queue 1 item 12)")
    strides, dilations = _pair(stride, n), _pair(dilation, n)
    pads = _conv_padding(padding, n, x.shape[2:], weight.shape[2:], strides, dilations)
    if any(a != b for a, b in pads):
        # F.pad takes the last dim first
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        pads = [(0, 0)] * n
    return _CONV[n](x, weight, bias, strides, [a for a, _ in pads], dilations, groups)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCL",
           name=None):
    """1-D convolution, ``weight`` ``[out, in / groups, k]``."""
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 1, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCHW",
           name=None):
    """2-D convolution, ``weight`` ``[out, in / groups, kh, kw]``."""
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 2, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCDHW",
           name=None):
    """3-D convolution, ``weight`` ``[out, in / groups, kd, kh, kw]``."""
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 3, data_format)


def _transpose_not_ported(*args, **kwargs):
    raise NotImplementedError("transposed convolutions are not ported yet "
                              "(ROADMAP.md, Queue 1 item 12)")


conv1d_transpose = conv2d_transpose = conv3d_transpose = _transpose_not_ported
