"""Fused LayerNorm of the port with the closed-form backward
(``paddle_tpu/ops/layer_norm.py``).

Statistics are computed and applied in f32 whatever the input dtype, and the
result is cast back. The backward saves ``(x, mu, rstd, w)``, not the
normalised tensor, and recomputes it:

    x_hat = (x - mu) rstd,   g = dy w
    dx    = rstd (g - mean(g) - x_hat mean(g x_hat))
    dw    = sum_tokens dy x_hat,   db = sum_tokens dy

It is jnp in the reference, not a Pallas kernel, so it is plain PyTorch here.
"""
from __future__ import annotations

import torch

from ..amp import cast_inputs


def _stats(xf, eps):
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return mu, rstd


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        xf = x.float()
        mu, rstd = _stats(xf, eps)
        ctx.save_for_backward(x, mu, rstd, w)
        return ((xf - mu) * rstd * w.float() + b.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, w = ctx.saved_tensors
        dyf = dy.float()
        xhat = (x.float() - mu) * rstd
        g = dyf * w.float()
        mg = g.mean(dim=-1, keepdim=True)
        mgx = (g * xhat).mean(dim=-1, keepdim=True)
        dx = (rstd * (g - mg - xhat * mgx)).to(x.dtype)
        red = tuple(range(dy.ndim - 1))
        dw = (dyf * xhat).sum(dim=red).to(w.dtype)
        db = dyf.sum(dim=red).to(w.dtype)
        return dx, dw, db, None


def layer_norm_fused(x, w, b, eps=1e-5):
    """LayerNorm over the last dim of ``x`` with weight ``w`` and bias ``b``,
    differentiable in all three by the closed-form backward; in an
    ``auto_cast`` scope its inputs of the scope's dtype go up to f32 (the
    ``layer_norm`` op is on the black list)."""
    return _LayerNorm.apply(*cast_inputs("layer_norm", x, w, b), eps)
