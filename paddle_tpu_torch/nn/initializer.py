"""Weight initialisers of the port (``paddle_tpu/nn/initializer.py``): each
draws a new f32 tensor on ``device`` from ``generator`` (``None``: the
device's default generator)."""
from __future__ import annotations

import math

import torch


def _fans(shape):
    """Fan in and out as the reference's ``_fans``: ``[in, out]`` for a
    matrix, the length twice for a vector."""
    if len(shape) == 1:
        return shape[0], shape[0]
    return shape[0], shape[1]


def normal(shape, std, generator, device):
    """``Normal(0, std)``."""
    return torch.empty(tuple(shape), device=device).normal_(0.0, std, generator=generator)


def xavier_normal(shape, generator, device):
    """``XavierNormal()``: Normal(0, sqrt(2 / (fan_in + fan_out)))."""
    fan_in, fan_out = _fans(tuple(shape))
    return normal(shape, math.sqrt(2.0 / (fan_in + fan_out)), generator, device)


def conv_normal(shape, generator, device):
    """The reference's conv default (``nn/layer/conv.py:24-27``):
    Normal(0, sqrt(2 / fan_in)), fan_in = in / groups times the kernel's
    size, i.e. the product of ``shape[1:]`` of ``[out, in / groups, *k]``."""
    return normal(shape, math.sqrt(2.0 / math.prod(shape[1:])), generator, device)
