"""Activation functionals of the port (``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch.nn.functional as F


def gelu(x, approximate=False):
    """GELU with the reference's signature: the exact erf form, or with
    ``approximate=True`` the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    """max(x, 0)."""
    return F.relu(x)
