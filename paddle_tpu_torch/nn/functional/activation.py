"""Activation functionals of the port (``paddle_tpu/nn/functional/activation.py``).

Each is the reference's formula in PyTorch ops on tensors. The random ones
(``rrelu`` in training, ``gumbel_softmax``) take ``generator=`` and draw
from the current random stream without one. ``softmax`` and
``log_softmax`` run in f32 in an ``auto_cast`` scope (the black list).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...framework import random as _random


def _gen(generator, device):
    return generator if generator is not None else _random.next_generator(device)


def relu(x, name=None):
    """max(x, 0)."""
    return F.relu(x)


def relu6(x, name=None):
    return F.relu6(x)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def gelu(x, approximate=False, name=None):
    """GELU with the reference's signature: the exact erf form, or with
    ``approximate=True`` the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold, torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return F.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, ``weight * x`` elsewhere; a weight of more than
    one element is per channel (dim 1, or the last dim for NHWC)."""
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.ndim
    shape[1 if data_format == "NCHW" else x.ndim - 1] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.3333333, training=True, name=None, generator=None):
    """Leaky ReLU whose negative slope is drawn Uniform(lower, upper) per
    entry in training and is their mean in eval."""
    if training:
        slope = torch.empty(x.shape, device=x.device).uniform_(lower, upper,
                                                              generator=_gen(generator, x.device))
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def swish(x, name=None):
    return F.silu(x)


silu = swish


def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


def softplus(x, beta=1, threshold=20, name=None):
    return torch.where(beta * x > threshold, x, F.softplus(beta * x) / beta)


def softsign(x, name=None):
    return x / (1 + x.abs())


def tanh(x, name=None):
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``; f32 in an ``auto_cast`` scope (black list)."""
    (x,) = cast_inputs("softmax", x)
    return torch.softmax(x if dtype is None else x.to(getattr(torch, str(dtype))), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax over ``axis``; f32 in an ``auto_cast`` scope (black list)."""
    (x,) = cast_inputs("log_softmax", x)
    return torch.log_softmax(x if dtype is None else x.to(getattr(torch, str(dtype))), dim=axis)


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def maxout(x, groups, axis=1, name=None):
    """The max over each group of ``groups`` consecutive channels of
    ``axis`` (``c / groups`` outputs)."""
    shape = list(x.shape)
    axis = axis % x.ndim
    return x.reshape(shape[:axis] + [shape[axis] // groups, groups] + shape[axis + 1:]).amax(axis + 1)


def glu(x, axis=-1, name=None):
    return F.glu(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, generator=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g``; with
    ``hard`` the one-hot of its argmax, with the soft gradient."""
    u = torch.empty(x.shape, device=x.device).uniform_(generator=_gen(generator, x.device))
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        y_hard = torch.zeros_like(y).scatter_(axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = (y_hard - y).detach() + y
    return y


def celu(x, alpha=1.0, name=None):
    """max(0, x) + min(0, alpha (exp(x / alpha) - 1))."""
    return (torch.clamp(x, min=0) + torch.clamp(alpha * (torch.exp(x / alpha) - 1.0), max=0)).to(x.dtype)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def relu_(x, name=None):
    return F.relu_(x)


def elu_(x, alpha=1.0, name=None):
    return F.elu_(x, alpha=alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def tanh_(x, name=None):
    return x.tanh_()


__all__ = ["relu", "relu6", "elu", "selu", "gelu", "sigmoid", "hardsigmoid", "hardswish",
           "hardtanh", "hardshrink", "softshrink", "tanhshrink", "leaky_relu", "prelu", "rrelu",
           "swish", "silu", "mish", "softplus", "softsign", "tanh", "softmax", "log_softmax",
           "log_sigmoid", "maxout", "glu", "gumbel_softmax", "celu", "thresholded_relu", "relu_",
           "elu_", "softmax_", "tanh_"]
