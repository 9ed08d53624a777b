"""Activation functionals of the port (``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast_inputs


def gelu(x, approximate=False):
    """GELU with the reference's signature: the exact erf form, or with
    ``approximate=True`` the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    """max(x, 0)."""
    return F.relu(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``; f32 in an ``auto_cast`` scope (black list)."""
    (x,) = cast_inputs("softmax", x)
    return torch.softmax(x if dtype is None else x.to(getattr(torch, str(dtype))), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax over ``axis``; f32 in an ``auto_cast`` scope (black list)."""
    (x,) = cast_inputs("log_softmax", x)
    return torch.log_softmax(x if dtype is None else x.to(getattr(torch, str(dtype))), dim=axis)
