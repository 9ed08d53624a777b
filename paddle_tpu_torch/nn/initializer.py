"""Weight initialisers of the port (``paddle_tpu/nn/initializer.py``).

An initialiser is a callable ``init(shape, dtype="float32", generator=None,
device=None)`` that makes a new tensor on ``device``; the random ones draw
from ``generator`` or, without one, from the next key of the current random
stream (:func:`paddle_tpu_torch.framework.random.next_generator`), as the
reference's draw from its ``split_key``. The fans follow the reference's
``_fans``: ``[in, out]`` for a matrix, the length twice for a vector, and
``[out, in, *k]`` (the conv layout: ``in * k`` and ``out * k``) for three
or more dims, which also reads an ``[E, D, H]`` expert stack as a conv
kernel (ROADMAP.md, Queue 3, "Faults in the reference").

The functions ``normal``, ``xavier_normal`` and ``conv_normal`` are the
layers' defaults, taking the generator and device positionally.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import random as _random

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "Bilinear", "set_global_initializer", "normal", "xavier_normal", "conv_normal"]


def _dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def _gen(generator, device):
    return generator if generator is not None else _random.next_generator(device)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype="float32", generator=None, device=None):
        raise NotImplementedError

    @staticmethod
    def _empty(shape, dtype, device):
        return torch.empty(tuple(shape), dtype=_dtype(dtype), device=device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype), device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        return self._empty(shape, dtype, device).normal_(self.mean, self.std,
                                                         generator=_gen(generator, device))


class TruncatedNormal(Initializer):
    """Normal(mean, std) truncated to two standard deviations."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        out = self._empty(shape, torch.float32, device)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=_gen(generator, device))
        return (self.mean + self.std * out).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        return self._empty(shape, dtype, device).uniform_(self.low, self.high,
                                                          generator=_gen(generator, device))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return Normal(0.0, std)(shape, dtype, generator, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return Uniform(-limit, limit)(shape, dtype, generator, device)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi = self.fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype, generator, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi = self.fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, generator, device)


class Assign(Initializer):
    """A given value (array or tensor) of exactly the parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        v = self.value
        out = (v.detach().clone() if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v))).to(dtype=_dtype(dtype), device=device)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"Assign shape {tuple(out.shape)} != {tuple(shape)}")
        return out


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix over the first dim against the rest,
    times ``gain``."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        out = self._empty(shape, torch.float32, device)
        torch.nn.init.orthogonal_(out, gain=self.gain, generator=_gen(generator, device))
        return out.to(_dtype(dtype))


class Dirac(Initializer):
    """The identity convolution kernel ``[out, in, *k]`` (per group)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i, *centers)] = 1.0
        return torch.as_tensor(out).to(dtype=_dtype(dtype), device=device)


class Bilinear(Initializer):
    """The bilinear-upsampling kernel of a transposed conv
    ``[c_out, c_in, kh, kw]``: the separable triangle filter on the
    diagonal channel pairs."""

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        out = np.zeros(shape, np.float32)
        kh, kw = shape[-2], shape[-1]

        def tri(k):
            f = (k + 1) // 2
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            return np.asarray([1 - abs(i / f - c) for i in range(k)])

        kern = np.outer(tri(kh), tri(kw))
        for i in range(shape[0]):
            out[i, min(i, shape[1] - 1)] = kern
        return torch.as_tensor(out).to(dtype=_dtype(dtype), device=device)


_GLOBAL_INITIALIZER = {"weight": None, "bias": None}


def set_global_initializer(weight_init=None, bias_init=None):
    """Default initialisers for the weights and biases of layers made from
    now on (None resets to each layer's own default)."""
    _GLOBAL_INITIALIZER["weight"] = weight_init
    _GLOBAL_INITIALIZER["bias"] = bias_init


def global_initializer(is_bias):
    return _GLOBAL_INITIALIZER["bias" if is_bias else "weight"]


def make(shape, attr, default, generator, device, is_bias=False):
    """A parameter's initial value, with the reference's precedence: the
    ``initializer`` of ``attr`` (a parameter attribute), else the global
    one (:func:`set_global_initializer`), else ``default``. As there, an
    initialiser passed as ``attr`` itself has no ``initializer`` and is
    not used."""
    init = (getattr(attr, "initializer", None) or global_initializer(is_bias) or default)
    return init(tuple(shape), "float32", generator, device)


# -- the layers' defaults -----------------------------------------------------------
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
