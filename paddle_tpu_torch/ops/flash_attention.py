"""Flash-attention forward (kernel K1): the CUDA kernel, its plain version and
its availability rule.

Counterpart of ``paddle_tpu/ops/flash_attention.py``, whose ``_flash_fwd``
launches the Pallas kernel ``_fwd_kernel``; here :func:`flash_attention_fwd`
launches ``csrc/flash_attention_fwd.cu``. q, k, v are ``[b, s, h, d]``; the
result is ``out`` ``[b, s, h, d]`` in the input dtype and ``lse``
``[b, h, s]`` f32 (``m + log l`` in scaled-logit units, which the backward
kernel K2 will read).

A CPU tensor takes the plain version :func:`_reference_attention`. A CUDA
tensor launches the kernel or raises: there is no fallback. The backward
kernel K2 comes with the training slice, so a gradient through this function
raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda

#: Head dims and dtypes the CUDA kernel is compiled for.
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535  # grid.y = heads, grid.z = batch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_available(q_shape, k_shape=None, dtype=torch.float32, device_type="cuda") -> bool:
    """Whether the kernel takes this self-attention call: q (and k, if given)
    ``[b, s, h, d]`` with equal shapes, ``d`` in :data:`HEAD_DIMS`, ``dtype``
    in :data:`DTYPES`, ``b`` and ``h`` within the launch grid, on a CUDA or
    CPU device (a CPU tensor runs the plain version). Shape, dtype and device
    only: never whether the kernel builds."""
    if len(q_shape) != 4 or (k_shape is not None and tuple(k_shape) != tuple(q_shape)):
        return False
    b, s, h, d = q_shape
    return (device_type in ("cuda", "cpu") and dtype in DTYPES and d in HEAD_DIMS
            and s >= 1 and 1 <= b <= _MAX_GRID_YZ and 1 <= h <= _MAX_GRID_YZ)


def _reference_attention(q, k, v, causal):
    """The plain version: ``(out, lse)`` computed in f32 by matmul + softmax."""
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        s = logits.shape[-1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.softmax(logits, dim=-1) @ vh
    return out.transpose(1, 2).to(q.dtype), lse


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _cuda.load("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal):
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention_fwd: q, k, v on different devices "
                         f"({q.device}, {k.device}, {v.device})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_fwd: the kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not flash_attention_available(tuple(q.shape), tuple(k.shape), q.dtype, "cuda") \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_fwd: the kernel takes equal [b, s, h, d] shapes with "
                         f"d in {HEAD_DIMS}; got q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: the kernel needs unit stride on the head dim")
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                       b, s, h, d, strides, int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


def _forward(q, k, v, causal):
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention backward is kernel K2, which comes with the training slice; "
            "the port's flash kernel is forward-only")


def flash_attention_fwd(q, k, v, causal=False):
    """K1: ``(out [b, s, h, d], lse [b, h, s] f32)`` of causal or full
    self-attention with scale ``1/sqrt(d)``. Launches the CUDA kernel on CUDA
    tensors (counted in ``flash_attention_fwd.launches``), the plain version
    on CPU tensors."""
    return _FlashForward.apply(q, k, v, bool(causal))


flash_attention_fwd.launches = 0
