"""Convolution functionals of the port (``paddle_tpu/nn/functional/conv.py``):
``conv1d/2d/3d`` and their transposes.

The reference's convolutions are ``jax.lax.conv_general_dilated``, no Pallas
kernel, so here they are ``torch.nn.functional.conv{1,2,3}d`` and
``conv_transpose{1,2,3}d`` (cuDNN on the card). A ``data_format`` ending in
``C`` (``NLC``, ``NHWC``, ``NDHWC``) is channel-last: the channels are
moved to dim 1 and back.

The transposed convolutions follow Paddle's definition, which the
reference's misses (ROADMAP.md, "Faults in the reference"): its padding
leaves out the dilation, its ``"IO"`` kernel spec raises at ``groups`` > 1
and it ignores ``output_size``.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...amp import cast_inputs

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_TRANSPOSE = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _channel_last(data_format, n, name):
    if data_format not in _FORMATS[n]:
        raise ValueError(f"{name}: data_format must be one of {_FORMATS[n]}, got {data_format!r}")
    return data_format == _FORMATS[n][1]


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
    if _channel_last(data_format, n, f"conv{n}d"):
        return _convnd(x.movedim(-1, 1), weight, bias, stride, padding, dilation, groups, n,
                       _FORMATS[n][0]).movedim(1, -1)
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


def _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                      output_size, n, data_format):
    name = f"conv{n}d_transpose"
    x, weight, bias = cast_inputs(name, x, weight, bias)
    if _channel_last(data_format, n, name):
        return _convnd_transpose(x.movedim(-1, 1), weight, bias, stride, padding, output_padding,
                                 dilation, groups, output_size, n, _FORMATS[n][0]).movedim(1, -1)
    strides, dilations = _pair(stride, n), _pair(dilation, n)
    sizes, ks = list(x.shape[2:]), list(weight.shape[2:])
    pads = _conv_padding(padding, n, sizes, ks, strides, dilations)
    # the whole output of each input element's scatter, before any padding is cut
    full = [(size - 1) * s + d * (k - 1) + 1 for size, s, d, k in zip(sizes, strides, dilations, ks)]
    if output_size is None:
        extra = _pair(output_padding, n)
    else:
        if any(_pair(output_padding, n)):
            raise ValueError(f"{name}: output_padding and output_size are mutually exclusive")
        want = [int(v) for v in (list(output_size) if isinstance(output_size, (list, tuple))
                                 else [output_size] * n)][-n:]
        extra = [w - (f - a - b) for w, f, (a, b) in zip(want, full, pads)]
        for e, s, d, w in zip(extra, strides, dilations, want):
            if not 0 <= e < max(s, d):
                raise ValueError(f"{name}: output_size {w} is not reachable: it must lie in "
                                 f"[{w - e}, {w - e + max(s, d)})")
    if all(a == b for a, b in pads):
        return _TRANSPOSE[n](x, weight, bias, strides, [a for a, _ in pads], extra, groups,
                             dilations)
    # uneven padding: the whole output, then cut (a negative pad) before and after
    y = _TRANSPOSE[n](x, weight, None, strides, 0, 0, groups, dilations)
    y = F.pad(y, [p for (a, b), e in reversed(list(zip(pads, extra))) for p in (-a, e - b)])
    return y if bias is None else y + bias.view([1, -1] + [1] * n)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, dilation=1,
                     groups=1, output_size=None, data_format="NCL", name=None):
    """The gradient of ``conv1d`` as a layer: each input element scatters
    ``weight`` ``[in, out / groups, k]`` into the output, ``stride`` apart,
    the taps ``dilation`` apart; ``padding`` cuts the output's ends,
    ``output_padding`` (or ``output_size``, which fixes it) adds to the
    end."""
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                             output_size, 1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, dilation=1,
                     groups=1, output_size=None, data_format="NCHW", name=None):
    """:func:`conv1d_transpose` in 2-D, ``weight`` ``[in, out / groups, kh,
    kw]``."""
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                             output_size, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, dilation=1,
                     groups=1, output_size=None, data_format="NCDHW", name=None):
    """:func:`conv1d_transpose` in 3-D."""
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                             output_size, 3, data_format)
