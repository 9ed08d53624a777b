"""Flat flash attention (kernels K3 and K3b): masked, GQA and packed-qkv
attention through CUDA kernels, their plain versions, their availability
rule and the autograd pair.

Counterpart of ``paddle_tpu/ops/flash_attention_flat.py``, whose
``_fwd_call`` launches the Pallas kernel ``_fwd_kernel`` and whose
``_bwd_call`` launches ``_bwd_kernel``; here :func:`flash_flat_fwd`
launches ``csrc/flash_flat_fwd.cu`` (K3) and :func:`flash_flat_bwd`
launches ``csrc/flash_flat_bwd.cu`` (K3b). The reference's "flat lanes"
and head groups are Mosaic layout rules; on Hopper a flat ``[b, s, h*d]`` or
packed ``[b, s, 3*h*d]`` operand is a ``[b, s, h, d]`` view with strides, so
q, k, v are ``[b, s, h, d]`` tensors with a unit head-dim stride and no copy
is made. The optional additive bias is ``[b|1, 1, s, s]`` (f32, or the
operands' 16-bit type; finite: use -1e30, not -inf), broadcast over heads, read through its own
strides (batch stride 0 for ``[1, 1, s, s]``).

The forward gives ``out`` ``[b, s, h, d]`` in the input dtype and
``stats`` ``[2, b, h, s]`` f32: the row max ``m`` of the scaled, biased
scores and ``log l``, kept apart (``m + log l`` is the reference's lse) so
that the backward's ``p = exp(x - m - log l)`` stays exact on a row whose
every key is masked, where ``m`` is about -1e30 and ``m + log l`` would
round to ``m``. Such a row averages V uniformly, as the plain composite
does, and gets the composite's gradient.

A CPU tensor takes the plain versions :func:`_reference_flat_fwd` and
:func:`_reference_flat_bwd`. A CUDA tensor launches the kernel or raises:
there is no fallback. The reference's ``set_blocks`` and its autotune hook
set TPU block sizes and are not ported.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..framework.flags import flag
from . import _cuda
from .flash_attention import (_count_dtype, flash_attention_available, gradient_buffers,
                              kernel_operand)

#: Operand dtypes the flat kernels are compiled for: f32 (the SIMT bodies),
#: bf16 and float16 (one tensor-core instance each, as K1/K2's).
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: Bias dtypes: f32, or a 16-bit bias of the operands' own type (f32
#: operands take any of the three). A bool mask is converted to 0 / -1e30
#: f32 by the caller.
BIAS_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def bias_dtype_ok(bias_dtype, dtype) -> bool:
    """Whether the kernels take a bias of ``bias_dtype`` beside operands of
    ``dtype``."""
    return bias_dtype == torch.float32 or (bias_dtype in BIAS_DTYPES
                                           and dtype in (torch.float32, bias_dtype))


def enabled(qkv_shape=None, dtype=torch.float32, device_type="cuda") -> bool:
    """Whether the flat kernels take a call: ``FLAGS_flash_flat`` is on and,
    given the packed shape ``[b, s, 3, h, d]``, the kernels' own limits hold
    (those of K1: ``d`` of 64 or 128, ``b`` and ``h`` within the launch
    grid, a CUDA or CPU device; and its own :data:`DTYPES`). The reference's TPU rules (``s >=
    256``, ``s`` a multiple of the block, ``s <= 2048``, the head-group VMEM
    budget) do not apply: the kernels mask a ragged ``s`` and stream any
    length."""
    if not flag("FLAGS_flash_flat"):
        return False
    if qkv_shape is None:
        return True
    b, s, three, h, d = qkv_shape
    return (three == 3 and dtype in DTYPES
            and flash_attention_available((b, s, h, d), None, dtype, device_type))


def mask_supported(b, s, h, d, mask_shape) -> bool:
    """Additive ``[b|1, 1, s, s]`` masks, as in the reference. Entries must
    be FINITE (-1e30, not -inf). The reference's ``s <= 1024`` (a whole mask
    row resident in VMEM) is a TPU rule and does not apply."""
    ms = tuple(mask_shape)
    return len(ms) == 4 and ms[1] == 1 and ms[2] == s and ms[3] == s and ms[0] in (1, b)


def _visible(s, device):
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def _scores(q, k, bias, causal):
    """f32 ``x = q k^T / sqrt(d) + bias`` ``[b, h, s, s]``, causal pairs at
    -inf (excluded, as the kernels exclude them)."""
    qh, kh = (t.transpose(1, 2).float() for t in (q, k))
    x = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        x = x + bias.float()
    if causal:
        x = x.masked_fill(~_visible(x.shape[-1], x.device), float("-inf"))
    return x


def _reference_flat_fwd(q, k, v, bias, causal):
    """The plain version of K3: ``(out, stats)`` computed in f32 by matmul
    and softmax."""
    x = _scores(q, k, bias, causal)
    m = x.amax(dim=-1)
    p = torch.exp(x - m[..., None])
    l = p.sum(dim=-1)
    out = (p @ v.transpose(1, 2).float()) / l[..., None]
    return out.transpose(1, 2).to(q.dtype), torch.stack([m, torch.log(l)])


def _reference_flat_bwd(q, k, v, bias, out, stats, dout, causal):
    """The plain version of K3b: the FlashAttention-2 backward from K3's
    statistics and ``di = rowsum(dO o O)``, in f32, by matmuls. Returns
    ``(dq, dk, dv)`` ``[b, s, h, d]`` in the input dtype."""
    qh, kh, vh, oh, gh = (t.transpose(1, 2).float() for t in (q, k, v, out, dout))
    scale = 1.0 / math.sqrt(q.shape[-1])
    m, logl = stats[0].float()[..., None], stats[1].float()[..., None]
    p = torch.exp((_scores(q, k, bias, causal) - m) - logl)
    di = (gh * oh).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ gh
    ds = p * (gh @ vh.transpose(-1, -2) - di)
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def _check_bias(bias, b, s, dtype, device, who):
    """The bias as the kernels take it (unit key stride), and its (batch,
    query) element strides."""
    if bias is None:
        return None, (0, 0)
    if tuple(bias.shape) not in ((b, 1, s, s), (1, 1, s, s)) \
            or not bias_dtype_ok(bias.dtype, dtype) or bias.device != device:
        raise ValueError(f"{who}: the bias must be an f32 (or {dtype}) [b|1, 1, s, s] tensor on "
                         f"{device}; got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if bias.stride(-1) != 1:
        bias = bias.contiguous()
    return bias, (bias.stride(0) if bias.shape[0] > 1 else 0, bias.stride(2))


def _check_qkv(tensors, who):
    q = tensors[0]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{who}: operands on different devices")
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in DTYPES:
        raise TypeError(f"{who}: the kernel takes float32, bfloat16 or float16 operands of one dtype; "
                        f"got {[str(t.dtype) for t in tensors]}")
    if not flash_attention_available(tuple(q.shape), None, q.dtype, "cuda") \
            or any(tuple(t.shape) != tuple(q.shape) for t in tensors):
        raise ValueError(f"{who}: the kernel takes equal [b, s, h, d] shapes with d in (64, 128); "
                         f"got {[tuple(t.shape) for t in tensors]}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{who}: the kernel needs unit stride on the head dim")


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    fn = _cuda.load("flash_flat_fwd").flash_flat_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(q, k, v, bias, causal):
    who = "flash_flat_fwd"
    _check_qkv((q, k, v), who)
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    b, s, h, d = q.shape
    bias, bias_strides = _check_bias(bias, b, s, q.dtype, q.device, who)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           None if bias is None else bias.data_ptr(), out.data_ptr(),
                           stats[0].data_ptr(), stats[1].data_ptr(), b, s, h, d, strides,
                           (ctypes.c_longlong * 2)(*bias_strides), int(bool(causal)),
                           _DTYPE_CODE[q.dtype], _DTYPE_CODE[bias.dtype] if bias is not None else 0,
                           stream)
    if rc != 0:
        raise RuntimeError(f"flash_flat_fwd: kernel launch failed with CUDA error {rc}")
    flash_flat_fwd.launches += 1
    _count_dtype(flash_flat_fwd, q.dtype)
    return out, stats


def flash_flat_fwd(q, k, v, bias=None, causal=False):
    """K3: ``(out [b, s, h, d], stats [2, b, h, s] f32)`` of attention with
    scale ``1/sqrt(d)``, an optional additive ``bias`` ``[b|1, 1, s, s]``
    and an optional causal mask. Launches the CUDA kernel on CUDA tensors
    (counted in ``flash_flat_fwd.launches``), the plain version on CPU
    tensors. Not differentiable itself: the entry points below are."""
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, bias, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_flat_fwd: no kernel for device {q.device}")
    return _reference_flat_fwd(q, k, v, bias, causal)


flash_flat_fwd.launches = 0
flash_flat_fwd.launches_by_dtype = {}


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = _cuda.load("flash_flat_bwd").flash_flat_bwd
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(q, k, v, bias, out, stats, dout, causal, grads):
    who = "flash_flat_bwd"
    dout = kernel_operand(dout)  # e.g. the expanded gradient of a sum or a mean
    _check_qkv((q, k, v, out, dout), who)
    b, s, h, d = q.shape
    bias, bias_strides = _check_bias(bias, b, s, q.dtype, q.device, who)
    if tuple(stats.shape) != (2, b, h, s) or stats.dtype != torch.float32 \
            or stats.device != q.device:
        raise ValueError(f"flash_flat_bwd: stats must be f32 [2, b, h, s] on {q.device}; got "
                         f"{tuple(stats.shape)} {stats.dtype} on {stats.device}")
    grads = gradient_buffers("flash_flat_bwd", q, grads)
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    stats = stats.contiguous()
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = grads
    strides = (ctypes.c_longlong * 24)(
        *(x for t in (q, k, v, out, dout) + tuple(grads) for x in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           None if bias is None else bias.data_ptr(), out.data_ptr(),
                           dout.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                           di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d,
                           strides, (ctypes.c_longlong * 2)(*bias_strides), int(bool(causal)),
                           _DTYPE_CODE[q.dtype], _DTYPE_CODE[bias.dtype] if bias is not None else 0,
                           stream)
    if rc != 0:
        raise RuntimeError(f"flash_flat_bwd: kernel launch failed with CUDA error {rc}")
    flash_flat_bwd.launches += 1
    _count_dtype(flash_flat_bwd, q.dtype)
    return dq, dk, dv


def flash_flat_bwd(q, k, v, bias, out, stats, dout, causal=False, grads=None):
    """K3b: ``(dq, dk, dv)`` ``[b, s, h, d]`` of :func:`flash_flat_fwd`
    given its ``out`` and ``stats`` and the output gradient ``dout``, with
    the same ``bias`` (which gets no gradient) and causal rule. Launches the
    CUDA kernel on CUDA tensors (counted in ``flash_flat_bwd.launches``),
    the plain version on CPU tensors. ``grads``, if given, is three
    ``[b, s, h, d]`` buffers (any strides with a unit head-dim stride, e.g.
    slices of one packed ``[b, s, 3, h, d]`` gradient) that receive dq, dk
    and dv, and are returned."""
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, bias, out, stats, dout, causal, grads)
    if q.device.type != "cpu":
        raise ValueError(f"flash_flat_bwd: no kernel for device {q.device}")
    result = _reference_flat_bwd(q, k, v, bias, out, stats, dout, causal)
    if grads is None:
        return result
    for buf, val in zip(grads, result):
        buf.copy_(val)
    return tuple(grads)


flash_flat_bwd.launches = 0
flash_flat_bwd.launches_by_dtype = {}


class _FlatFlash(torch.autograd.Function):
    """K3 over q, k, v ``[b, s, h, d]`` and an optional bias; the backward
    runs K3b. The counterpart of the reference's ``_flat`` and
    ``_flat_masked`` ``jax.custom_vjp``s; the bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        out, stats = flash_flat_fwd(q, k, v, bias, causal)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_flat_bwd(q, k, v, bias, out, stats, dout, ctx.causal)
        return dq, dk, dv, None, None


class _PackedFlatFlash(torch.autograd.Function):
    """K3 over the q, k, v views of one packed ``[b, s, 3, h, d]``
    projection (no copy), whose backward has K3b write dq, dk and dv through
    strides into slices of ONE packed gradient, as the reference's
    ``_flat_packed`` concatenates them."""

    @staticmethod
    def forward(ctx, qkv, causal):
        out, stats = flash_flat_fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, causal)
        ctx.save_for_backward(qkv, out, stats)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, stats = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        flash_flat_bwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, out, stats,
                       dout, ctx.causal,
                       grads=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
        return dqkv, None


def flash_packed(qkv, causal=False):
    """qkv ``[b, s, 3, h, d]`` (the qkv projection, read in place) ->
    ``[b, s, h, d]``; the gradient is one packed ``[b, s, 3, h, d]``
    tensor."""
    return _PackedFlatFlash.apply(qkv, bool(causal))


def flash_flat(q, k, v, causal=False):
    """q/k/v ``[b, s, h, d]`` -> ``[b, s, h, d]`` through K3/K3b."""
    return _FlatFlash.apply(q, k, v, None, bool(causal))


def flash_flat_masked(q, k, v, mask, causal=False):
    """Masked attention through K3/K3b. ``mask``: additive bias
    ``[b|1, 1, s, s]``, f32 or the operands' 16-bit type (a bool mask must be converted to
    0 / -1e30 by the caller). Gradients flow to q, k, v; the mask gets
    none. A ``[1, 1, s, s]`` mask is read with batch stride 0, where the
    reference broadcasts it to ``b``: the values are the same."""
    return _FlatFlash.apply(q, k, v, mask, bool(causal))


def flash_flat_gqa(q, k, v, causal=False, mask=None):
    """Grouped/multi-query attention: k/v have ``h_kv`` heads with
    ``h % h_kv == 0``. As in the reference, K/V heads are repeated to the
    query head count before the kernel (query head i reads K/V head
    ``i // (h // h_kv)``), so autograd sums the repeats' gradients."""
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv != 0:
        raise ValueError(f"GQA needs h_kv | h; got h={h}, h_kv={h_kv}")
    r = h // h_kv
    if r > 1:
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    if mask is not None:
        return flash_flat_masked(q, k, v, mask, causal)
    return flash_flat(q, k, v, causal)
