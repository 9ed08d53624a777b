"""Normalisation functionals of the port (``paddle_tpu/nn/functional/norm.py``):
``batch_norm`` with Paddle's semantics and ``sync_batch_norm``, its
data-parallel form; ``layer_norm``, ``instance_norm``, ``group_norm``,
``local_response_norm`` and ``rms_norm``.

Batch norm:

- ``momentum`` is the weight of the OLD running value (0.9), the complement
  of ``torch.nn.functional.batch_norm``'s;
- the running variance takes the BIASED batch variance, the one that
  normalises (torch's takes the unbiased one);
- for a bf16 or f16 ``x`` the affine ``weight``/``bias`` and the
  statistics run in f32: under AMP O2, ``x`` and the casts of the
  parameters are bf16 while the running buffers stay f32, and mixed-dtype
  batch norm wants every operand but ``x`` in f32. Otherwise they run in
  ``x``'s dtype.

A ``data_format`` that does not start with ``"NC"`` is channel-last: the
channels are the last dim. They are jnp in the reference, not Pallas
kernels, so here they are ATen's (``torch.native_batch_norm``,
``torch.nn.functional``'s norms) and the fused LayerNorm of
``ops/layer_norm.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...ops.layer_norm import layer_norm_fused


def _channel_last(data_format):
    return not data_format.startswith("NC")


def _channels_first(fn, x, data_format):
    """``fn`` of ``x`` with its channels at dim 1, in ``x``'s layout."""
    if not _channel_last(data_format):
        return fn(x)
    return fn(x.movedim(-1, 1)).movedim(1, -1)


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False, momentum=0.9,
               epsilon=1e-5, data_format="NCHW", use_global_stats=None, name=None):
    """Normalise ``x`` over every dim but the channels (dim 1). In training
    (and unless ``use_global_stats``) by the batch's mean and biased
    variance, and the running buffers move in place to ``momentum * old +
    (1 - momentum) * batch``; otherwise by the running buffers, untouched.
    A channel-last ``data_format`` takes the channels from the last dim."""
    if _channel_last(data_format):
        return batch_norm(x.movedim(-1, 1), running_mean, running_var, weight, bias, training,
                          momentum, epsilon, "NC", use_global_stats).movedim(1, -1)
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
    if _channel_last(data_format):
        return sync_batch_norm(x.movedim(-1, 1), running_mean, running_var, weight, bias, training,
                               momentum, epsilon, "NC", use_global_stats, group).movedim(1, -1)
    y, mean, var = _SyncBatchNorm.apply(x, weight, bias, g, epsilon)
    with torch.no_grad():
        running_mean.mul_(momentum).add_(mean.to(running_mean.dtype), alpha=1.0 - momentum)
        running_var.mul_(momentum).add_(var.to(running_var.dtype), alpha=1.0 - momentum)
    return y


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    """Normalise over the last ``len(normalized_shape)`` dims by their mean
    and biased variance, then ``* weight + bias`` (each optional). Over the
    last dim with both, the fused LayerNorm with its closed-form backward
    (``ops/layer_norm.py``), as the reference's hot path."""
    shape = list(normalized_shape) if isinstance(normalized_shape, (list, tuple)) else [
        normalized_shape]
    if len(shape) == 1 and weight is not None and bias is not None:
        return layer_norm_fused(x, weight, bias, epsilon)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    dtype = x.dtype
    return F.layer_norm(x, [int(d) for d in shape], None if weight is None else weight.to(dtype),
                        None if bias is None else bias.to(dtype), epsilon)


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW", name=None):
    """Normalise each sample's channel over its spatial dims (mean and
    biased variance), then the per-channel ``weight``/``bias``. With
    ``use_input_stats=False`` and running buffers, by those instead, as
    Paddle (the reference ignores both); the buffers are not updated (the
    ``InstanceNorm`` layers keep none)."""
    use_running = not use_input_stats and running_mean is not None and running_var is not None

    def fn(v):
        return F.instance_norm(v, running_mean if use_running else None,
                               running_var if use_running else None, weight, bias,
                               use_input_stats=not use_running, eps=eps)

    return _channels_first(fn, x, data_format)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None, data_format="NCHW",
               name=None):
    """Normalise each sample over each group of ``C / num_groups`` channels
    and its spatial dims, then the per-channel ``weight``/``bias``.
    Channels first only: a channel-last layout raises, as in the
    reference."""
    if _channel_last(data_format):
        raise NotImplementedError(f"group_norm: data_format={data_format!r}: channels first only, "
                                  "as in the reference")
    return F.group_norm(x, int(num_groups), weight, bias, epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
    """``x / (k + alpha * mean of x**2 over a window of size channels) **
    beta``, the window centred (``size // 2`` before, the rest after, zero
    padded); the channels are dim 1, or the last dim for a channel-last
    ``data_format`` (the reference always takes dim 1)."""
    return _channels_first(lambda v: F.local_response_norm(v, int(size), alpha, beta, k), x,
                           data_format)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """``x / sqrt(mean(x**2) + epsilon)`` over the last dim, in f32, cast
    back to ``x``'s dtype, then ``* weight`` (which promotes as a product
    does)."""
    xf = x.float()
    out = (xf / torch.sqrt(xf.square().mean(-1, keepdim=True) + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
