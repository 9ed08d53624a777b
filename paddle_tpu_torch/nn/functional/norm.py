"""Normalisation functionals of the port (``paddle_tpu/nn/functional/norm.py``):
``batch_norm`` with Paddle's semantics, and ``sync_batch_norm``, its
data-parallel form.

- ``momentum`` is the weight of the OLD running value (0.9), the complement
  of ``torch.nn.functional.batch_norm``'s;
- the running variance takes the BIASED batch variance, the one that
  normalises (torch's takes the unbiased one);
- for a bf16 or f16 ``x`` the affine ``weight``/``bias`` and the
  statistics run in f32: under AMP O2, ``x`` and the casts of the
  parameters are bf16 while the running buffers stay f32, and mixed-dtype
  batch norm wants every operand but ``x`` in f32. Otherwise they run in
  ``x``'s dtype.

It is jnp in the reference, not a Pallas kernel, so here it is
``torch.native_batch_norm`` (ATen's fused kernel and its backward).
"""
from __future__ import annotations

import torch

from ...amp import cast_inputs


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False, momentum=0.9,
               epsilon=1e-5, data_format="NCHW", use_global_stats=None, name=None):
    """Normalise ``x`` over every dim but the channels (dim 1). In training
    (and unless ``use_global_stats``) by the batch's mean and biased
    variance, and the running buffers move in place to ``momentum * old +
    (1 - momentum) * batch``; otherwise by the running buffers, untouched."""
    if not data_format.startswith("NC"):
        raise NotImplementedError(f"batch_norm: data_format={data_format!r} is not ported, "
                                  "only the channels-first layouts")
    (x,) = cast_inputs("batch_norm", x)  # the running buffers are updated in place
    dtype = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    w = None if weight is None else weight.to(dtype)
    b = None if bias is None else bias.to(dtype)
    if not training or use_global_stats:
        return torch.native_batch_norm(x, w, b, running_mean.to(dtype), running_var.to(dtype),
                                       False, 0.0, epsilon)[0]
    y, mean, invstd = torch.native_batch_norm(x, w, b, None, None, True, 0.0, epsilon)
    with torch.no_grad():
        # the kernel keeps 1 / sqrt(var + eps) of the biased variance
        var = invstd.double().pow(-2).sub(epsilon).to(running_var.dtype)
        running_mean.mul_(momentum).add_(mean, alpha=1.0 - momentum)
        running_var.mul_(momentum).add_(var, alpha=1.0 - momentum)
    return y


class _SyncBatchNorm(torch.autograd.Function):
    """Training batch norm whose statistics are the group's: the per-channel
    sum, sum of squares and count all-reduced in f32, the variance the
    biased one. The backward all-reduces the per-channel sums of ``dy`` and
    ``dy * x_hat`` and divides by the group's count; the weight and bias
    gradients stay this rank's (a data-parallel reducer averages them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, epsilon):
        from ...distributed import collective

        dims = [d for d in range(x.ndim) if d != 1]
        xf = x.float()
        count = torch.full((1,), x.numel() / x.shape[1], dtype=torch.float32, device=x.device)
        stats = torch.cat([xf.sum(dims), xf.square().sum(dims), count])
        collective.all_reduce(stats, group=group)
        c = x.shape[1]
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean.square()).clamp(min=0.0)
        invstd = torch.rsqrt(var + epsilon)
        shape = [1, c] + [1] * (x.ndim - 2)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        y = xhat
        if weight is not None:
            y = y * weight.float().view(shape)
        if bias is not None:
            y = y + bias.float().view(shape)
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.group, ctx.dims = group, dims
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        from ...distributed import collective

        xhat, invstd, weight, n = ctx.saved_tensors
        c = xhat.shape[1]
        shape = [1, c] + [1] * (xhat.ndim - 2)
        dy = gy.float()
        sums = torch.cat([dy.sum(ctx.dims), (dy * xhat).sum(ctx.dims)])
        dweight = sums[c:].clone() if weight is not None else None
        dbias = sums[:c].clone() if ctx.bias_dtype is not None else None
        collective.all_reduce(sums, group=ctx.group)
        scale = invstd if weight is None else invstd * weight.float()
        dx = scale.view(shape) * (dy - (sums[:c] / n).view(shape)
                                  - xhat * (sums[c:] / n).view(shape))
        return (dx.to(gy.dtype),
                None if dweight is None else dweight.to(weight.dtype),
                None if dbias is None else dbias.to(ctx.bias_dtype),
                None, None)


def sync_batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
                    momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None,
                    group=None):
    """:func:`batch_norm` whose training statistics are those of the whole
    batch across ``group`` (the fleet's ``dp`` group by default, or the
    world): at dp 2 it equals ``batch_norm`` over the two ranks' batches
    joined, as the reference's batch norm over a sharded batch does. With
    one rank, or outside training, it is :func:`batch_norm`."""
    import torch.distributed as dist

    g = None
    if training and not use_global_stats and dist.is_available() and dist.is_initialized():
        from ...distributed import collective

        g = collective._group(group)
    if g is None or g.nranks == 1:
        return batch_norm(x, running_mean, running_var, weight, bias, training, momentum, epsilon,
                          data_format, use_global_stats)
    if not data_format.startswith("NC"):
        raise NotImplementedError(f"sync_batch_norm: data_format={data_format!r} is not ported, "
                                  "only the channels-first layouts")
    y, mean, var = _SyncBatchNorm.apply(x, weight, bias, g, epsilon)
    with torch.no_grad():
        running_mean.mul_(momentum).add_(mean.to(running_mean.dtype), alpha=1.0 - momentum)
        running_var.mul_(momentum).add_(var.to(running_var.dtype), alpha=1.0 - momentum)
    return y
