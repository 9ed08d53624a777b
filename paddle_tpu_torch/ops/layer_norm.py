"""Fused LayerNorm forward of the port (``paddle_tpu/ops/layer_norm.py``).

Statistics are computed and applied in f32 whatever the input dtype, and the
result is cast back. The closed-form backward of the reference comes with the
training slice; until then autograd differentiates this composite.
"""
from __future__ import annotations

import torch


def layer_norm_fused(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * rstd * w.float() + b.float()).to(x.dtype)
