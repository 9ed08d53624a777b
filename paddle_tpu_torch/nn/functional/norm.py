"""Normalisation functionals of the port (``paddle_tpu/nn/functional/norm.py``):
``batch_norm`` with Paddle's semantics.

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


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False, momentum=0.9,
               epsilon=1e-5, data_format="NCHW", use_global_stats=None, name=None):
    """Normalise ``x`` over every dim but the channels (dim 1). In training
    (and unless ``use_global_stats``) by the batch's mean and biased
    variance, and the running buffers move in place to ``momentum * old +
    (1 - momentum) * batch``; otherwise by the running buffers, untouched."""
    if not data_format.startswith("NC"):
        raise NotImplementedError(f"batch_norm: data_format={data_format!r} is not ported, "
                                  "only the channels-first layouts")
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
