"""Flash attention (kernels K1 and K2): the CUDA kernels, their plain
versions, their availability rule and the autograd pair.

Counterpart of ``paddle_tpu/ops/flash_attention.py``, whose ``_flash_fwd``
launches the Pallas kernel ``_fwd_kernel`` and whose ``_flash_bwd`` launches
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``; here :func:`flash_attention_fwd`
launches ``csrc/flash_attention_fwd.cu`` (K1) and :func:`flash_attention_bwd`
launches ``csrc/flash_attention_bwd.cu`` (K2). q, k, v are ``[b, s, h, d]``;
the forward gives ``out`` ``[b, s, h, d]`` in the input dtype and ``lse``
``[b, h, s]`` f32 (``m + log l`` in scaled-logit units), which the backward
reads. ``_FlashAttention`` is the counterpart of the reference's
``jax.custom_vjp`` ``_flash``: its forward saves ``(q, k, v, out, lse)`` and
its backward runs K2.

A CPU tensor takes the plain versions :func:`_reference_attention` and
:func:`_reference_attention_bwd`. A CUDA tensor launches the kernel or
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda

#: Head dims and dtypes the CUDA kernel is compiled for.
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_GRID_YZ = 65535  # grid.y = heads, grid.z = batch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_attention_available(q_shape, k_shape=None, dtype=torch.float32, device_type="cuda") -> bool:
    """Whether the kernels take this self-attention call, forward (K1) and
    backward (K2) alike: q (and k, if given) ``[b, s, h, d]`` with equal
    shapes, ``d`` in :data:`HEAD_DIMS`, ``dtype`` in :data:`DTYPES`, ``b`` and
    ``h`` within the launch grid, on a CUDA or CPU device (a CPU tensor runs
    the plain versions). Shape, dtype and device only: never whether the
    kernel builds."""
    if len(q_shape) != 4 or (k_shape is not None and tuple(k_shape) != tuple(q_shape)):
        return False
    b, s, h, d = q_shape
    return (device_type in ("cuda", "cpu") and dtype in DTYPES and d in HEAD_DIMS
            and s >= 1 and 1 <= b <= _MAX_GRID_YZ and 1 <= h <= _MAX_GRID_YZ)


def needs_copy(t):
    """Whether a ``[b, s, h, d]`` operand must reach the kernels as a
    contiguous copy: its head dim has no unit stride; a dim longer than 1
    has stride 0 (the expanded gradient of a sum or a mean); or, in bf16 or
    float16, its base address or a ``b``, ``s``, ``h`` byte stride is off a
    16-byte boundary (the 16-bit kernels read by TMA, which needs that and
    takes no zero stride, and store 16-bit pairs; a dim of length 1 is never stepped,
    so its stride is exempt). Views of a packed ``[b, s, 3, h, d]``
    projection need none. f32 tensors take the SIMT kernels, for which
    alignment is moot."""
    if t.stride(-1) != 1 or any(n > 1 and st == 0 for n, st in zip(t.shape, t.stride())):
        return True
    if t.dtype not in (torch.bfloat16, torch.float16):
        return False
    size = t.element_size()
    return not _cuda.aligned(t) or any(n > 1 and (st * size) % _cuda.ALIGN
                                       for n, st in zip(t.shape[:3], t.stride()[:3]))


def kernel_operand(t):
    """``t``, or one contiguous copy of it where :func:`needs_copy` says
    so. The kernel runs on the copy: this is no fallback."""
    return t.clone(memory_format=torch.contiguous_format) if needs_copy(t) else t


def gradient_buffers(who, q, grads):
    """The dq, dk, dv buffers a backward kernel writes: ``grads`` as given
    (three buffers of q's shape, dtype and device, e.g. slices of one packed
    ``[b, s, 3, h, d]`` gradient), or three new ones if None. Raises
    ``ValueError`` for a buffer the kernels cannot write in place, one that
    :func:`needs_copy` would copy."""
    if grads is None:
        return tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    if any(tuple(g.shape) != tuple(q.shape) or g.dtype != q.dtype or g.device != q.device
           or needs_copy(g) for g in grads):
        raise ValueError(f"{who}: dq, dk, dv buffers must match q's shape, dtype and device, "
                         f"with unit stride on the head dim, no zero stride and, in bf16 or "
                         f"float16, a 16-byte aligned base and b, s, h strides")
    return tuple(grads)


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


def _count_dtype(wrapper, dtype):
    """One launch of ``wrapper``'s kernel instance for ``dtype``, in
    ``wrapper.launches_by_dtype`` (beside ``launches``, which counts them
    all): the AMP steps read which instance ran."""
    name = str(dtype).split(".")[-1]
    wrapper.launches_by_dtype[name] = wrapper.launches_by_dtype.get(name, 0) + 1


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
        raise TypeError(f"flash_attention_fwd: the kernel takes float32, bfloat16 or float16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not flash_attention_available(tuple(q.shape), tuple(k.shape), q.dtype, "cuda") \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_fwd: the kernel takes equal [b, s, h, d] shapes with "
                         f"d in {HEAD_DIMS}; got q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: the kernel needs unit stride on the head dim")
    q, k, v = (kernel_operand(t) for t in (q, k, v))
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
    _count_dtype(flash_attention_fwd, q.dtype)
    return out, lse


def _forward(q, k, v, causal):
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention_fwd(q, k, v, causal=False):
    """K1: ``(out [b, s, h, d], lse [b, h, s] f32)`` of causal or full
    self-attention with scale ``1/sqrt(d)``. Launches the CUDA kernel on CUDA
    tensors (counted in ``flash_attention_fwd.launches``), the plain version
    on CPU tensors. Differentiable in q, k and v: the gradient runs K2."""
    return _FlashAttention.apply(q, k, v, bool(causal))


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_dtype = {}


def _reference_attention_bwd(q, k, v, out, lse, dout, causal):
    """The plain version of K2: the FlashAttention-2 backward from ``lse``
    and ``di = rowsum(dO o O)``, in f32, by matmuls. Returns ``(dq, dk, dv)``
    ``[b, s, h, d]`` in the input dtype."""
    qh, kh, vh, oh, gh = (t.transpose(1, 2).float() for t in (q, k, v, out, dout))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse.float()[..., None])
    if causal:
        s = p.shape[-1]
        p = p.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=q.device).tril(), 0.0)
    di = (gh * oh).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ gh
    ds = p * (gh @ vh.transpose(-1, -2) - di)
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = _cuda.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(q, k, v, out, lse, dout, causal, grads):
    dout = kernel_operand(dout)  # e.g. the expanded gradient of a sum or a mean
    tensors = (q, k, v, out, dout)
    if len({t.device for t in tensors + (lse,)}) != 1:
        raise ValueError("flash_attention_bwd: q, k, v, out, lse, dout on different devices")
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in DTYPES or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: the kernel takes float32, bfloat16 or float16 q, k, v, out, "
                        f"dout of one dtype and a float32 lse; got "
                        f"{[str(t.dtype) for t in tensors]}, lse {lse.dtype}")
    b, s, h, d = q.shape
    if not flash_attention_available(tuple(q.shape), tuple(k.shape), q.dtype, "cuda") \
            or any(tuple(t.shape) != tuple(q.shape) for t in (v, out, dout)) \
            or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_attention_bwd: the kernel takes equal [b, s, h, d] shapes with d "
                         f"in {HEAD_DIMS} and lse [b, h, s]; got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} out{tuple(out.shape)} "
                         f"dout{tuple(dout.shape)} lse{tuple(lse.shape)}")
    grads = gradient_buffers("flash_attention_bwd", q, grads)
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention_bwd: the kernel needs unit stride on the head dim")
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    lse = lse.contiguous()
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = grads
    strides = (ctypes.c_longlong * 24)(*(x for t in (q, k, v, out, dout) + grads
                                         for x in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), b, s, h, d, strides, int(bool(causal)),
                           _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with CUDA error {rc}")
    flash_attention_bwd.launches += 1
    _count_dtype(flash_attention_bwd, q.dtype)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, grads=None):
    """K2: ``(dq, dk, dv)`` ``[b, s, h, d]`` of :func:`flash_attention_fwd`
    given its ``out`` and ``lse`` and the output gradient ``dout``. Launches
    the CUDA kernel on CUDA tensors (counted in
    ``flash_attention_bwd.launches``), the plain version on CPU tensors.
    ``grads``, if given, is three ``[b, s, h, d]`` buffers (any strides with a
    unit head-dim stride, e.g. slices of one packed ``[b, s, 3, h, d]``
    gradient) that receive dq, dk and dv, and are returned."""
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, dout, causal, grads)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    result = _reference_attention_bwd(q, k, v, out, lse, dout, causal)
    if grads is None:
        return result
    for buf, val in zip(grads, result):
        buf.copy_(val)
    return tuple(grads)


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_dtype = {}
