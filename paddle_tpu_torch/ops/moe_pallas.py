"""Sort-based MoE dispatch and combine around the grouped expert FFN
(kernels K4 and K4b), registered as implementation ``pallas_sorted`` of the
``moe`` kernel.

Counterpart of ``paddle_tpu/ops/moe_pallas.py`` (the module keeps its name,
as the registry keeps the impl name):

1. **dispatch**: a stable argsort of the T·K (token, expert) pairs by expert
   id; each pair's queue position is its offset from its expert's run start
   (a length-E+1 cumsum), so overflow past ``capacity`` drops in arrival
   order, exactly as the ``dense`` composite does. Pairs under ``drop_mask``
   sort past every expert and claim no slot. One gather fills the padded
   ``[E*cap, D]`` layout; empty slots take the zero token (row T). The
   first ``rows[e] = min(count[e], cap)`` rows of expert e hold its tokens.
2. **expert FFN**: :func:`grouped_ffn`, one ``torch.autograd.Function``
   whose forward is K4 (:func:`moe_grouped_ffn_fwd`,
   ``csrc/moe_grouped_ffn_fwd.cu``) and whose backward is K4b
   (:func:`moe_grouped_ffn_bwd`, ``csrc/moe_grouped_ffn_bwd.cu``). The
   forward saves the f32 pre-activation ``s``, as the reference's
   single-hidden-tile kernel does. The dispatch hands it ``rows`` (a device
   tensor, read by the kernels on the card: no host sync), and the kernels
   compute only the live rows; the padding rows get the values the
   reference computes for the zero token.
3. **combine**: a weighted scatter-add back to token order.

The dispatch and combine are plain PyTorch ops (jnp in the reference). The
padded capacity is ``capacity`` itself: the kernels mask a ragged last row
tile, so no rounding up is needed, and the dropping rule is set by
``capacity`` alone.

A CPU tensor takes the plain versions :func:`_reference_ffn_fwd` and
:func:`_reference_ffn_bwd`. A CUDA tensor that :func:`moe_available` accepts
launches K4/K4b or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda
from . import registry

__all__ = ["moe_dispatch_combine", "moe_available", "moe_kernel_available", "grouped_ffn",
           "sort_pairs", "moe_grouped_ffn_fwd", "moe_grouped_ffn_bwd"]

#: dtypes and activations the CUDA kernels are compiled for
DTYPES = (torch.float32, torch.bfloat16)
ACTIVATIONS = ("gelu", "relu", "silu")
_ACT_CODE = {"gelu": 0, "relu": 1, "silu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128            # rows and columns of the kernels' output tile (moe_grouped_ffn.cuh)
_MAX_GRID_YZ = 65535   # grid.y = row tiles, grid.z = experts
_TMA_ELEMS = 8         # bf16 elements in 16 bytes: TMA's stride and base alignment
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def moe_kernel_available(num_experts, d_model, d_hidden, capacity, dtype, activation,
                         device_type="cuda") -> bool:
    """Whether K4/K4b take a grouped FFN of ``num_experts`` experts of
    ``[d_model, d_hidden]`` at ``capacity`` rows each: ``dtype`` in
    :data:`DTYPES`, ``activation`` in :data:`ACTIVATIONS`, and the launch
    grid within its limits (experts on grid.z, row tiles of 128 on grid.y).
    The kernels mask every ragged tile, so D, H and the capacity need not be
    multiples of the tile; bf16 needs ``D % 8 == H % 8 == 0`` (the bf16
    kernels read their operands by TMA, whose row strides are 16-byte
    multiples). A CPU device runs the plain versions. Shape, dtype and
    device only: never whether the kernel builds."""
    tiles = max(-(-int(n) // _TILE) for n in (capacity, d_model, d_hidden))
    return (device_type in ("cuda", "cpu") and dtype in DTYPES and activation in ACTIVATIONS
            and 1 <= num_experts <= _MAX_GRID_YZ and min(capacity, d_model, d_hidden) >= 1
            and tiles <= _MAX_GRID_YZ
            and (dtype != torch.bfloat16 or (d_model % _TMA_ELEMS == 0
                                             and d_hidden % _TMA_ELEMS == 0)))


def moe_available(tokens, gate_vals, gate_idx, drop_mask, w1, b1, w2, b2, *, capacity,
                  activation) -> bool:
    """Availability predicate of ``pallas_sorted``: the operands' shapes fit
    together (tokens ``[T, D]``, gates ``[T, K]``, w1 ``[E, D, H]``, b1
    ``[E, 1, H]``, w2 ``[E, H, D]``, b2 ``[E, 1, D]``), the tokens and the
    four weights share one dtype and device type, and
    :func:`moe_kernel_available` takes the rest."""
    if tokens.ndim != 2 or w1.ndim != 3 or gate_idx.ndim != 2:
        return False
    T, D = tokens.shape
    E, _, H = w1.shape
    K = gate_idx.shape[1]
    shapes_fit = (tuple(w1.shape) == (E, D, H) and tuple(b1.shape) == (E, 1, H)
                  and tuple(w2.shape) == (E, H, D) and tuple(b2.shape) == (E, 1, D)
                  and tuple(gate_vals.shape) == (T, K) and tuple(gate_idx.shape) == (T, K)
                  and (drop_mask is None or tuple(drop_mask.shape) == (T, K)))
    tensors = (tokens, w1, b1, w2, b2)
    return (shapes_fit and len({t.dtype for t in tensors}) == 1
            and len({t.device.type for t in tensors + (gate_vals, gate_idx)}) == 1
            and moe_kernel_available(E, D, H, int(capacity), tokens.dtype, activation,
                                     tokens.device.type))


# -- the plain versions ------------------------------------------------------


def _act(s, activation):
    """The activation on f32 ``s``, in the kernels' formulas (GELU in the
    tanh form, as ``jax.nn.gelu``'s default)."""
    if activation == "gelu":
        return 0.5 * s * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (s + 0.044715 * s * s * s)))
    if activation == "relu":
        return torch.clamp_min(s, 0.0)
    if activation == "silu":
        return s * torch.sigmoid(s)
    raise ValueError(f"moe: unknown activation {activation!r}; expected one of {ACTIVATIONS}")


def _act_grad(s, activation):
    """d act / ds on f32 ``s`` (relu's is 0 at 0, as ``jax.nn.relu``'s)."""
    if activation == "gelu":
        s2 = s * s
        t = torch.tanh(_SQRT_2_OVER_PI * (s + 0.044715 * s2 * s))
        return 0.5 * (1.0 + t) + 0.5 * s * (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 0.134145 * s2)
    if activation == "relu":
        return (s > 0).to(s.dtype)
    if activation == "silu":
        sg = torch.sigmoid(s)
        return sg * (1.0 + s * (1.0 - sg))
    raise ValueError(f"moe: unknown activation {activation!r}; expected one of {ACTIVATIONS}")


def _live(x, rows, E):
    """``x [E*cap, W]`` with the rows of expert e at or past ``rows[e]`` set
    to 0 (``rows`` None: every row is live)."""
    if rows is None:
        return x
    cap = x.shape[0] // E
    keep = torch.arange(cap, device=x.device)[None, :] < rows.to(x.device).long()[:, None]
    return torch.where(keep.reshape(-1, 1), x, torch.zeros((), dtype=x.dtype, device=x.device))


def _reference_ffn_fwd(xg, w1, b1, w2, b2, activation, rows=None):
    """The plain version of K4: per-expert ``act(x @ w1 + b1) @ w2 + b2``
    over the ``[E*cap, D]`` layout as batched einsums in f32, with the
    kernel's rounding points; rows of expert e at or past ``rows[e]`` count
    as the zero token, whatever xg holds there. Returns ``(y [E*cap, D] in
    xg's dtype, s [E*cap, H] f32)``."""
    R, D = xg.shape
    E, _, H = w1.shape
    xs = _live(xg, rows, E).reshape(E, R // E, D).float()
    s = torch.einsum("ecd,edh->ech", xs, w1.float()) + b1.float()
    h = _act(s, activation).to(xg.dtype).float()
    y = torch.einsum("ech,ehd->ecd", h, w2.float()) + b2.float()
    return y.reshape(R, D).to(xg.dtype), s.reshape(R, H)


def _reference_ffn_bwd(xg, w1, b1, w2, b2, s, dy, activation, rows=None):
    """The plain version of K4b: ``(dx, dw1, db1, dw2, db2)`` from the saved
    f32 pre-activation ``s`` and ``dy``, in f32 with the kernel's rounding
    points (dy and dh cast to xg's dtype before their products, every sum in
    f32, the results cast to the operands' dtypes); rows of expert e at or
    past ``rows[e]`` count as the zero token with a zero gradient, whatever
    xg and dy hold there."""
    R, D = xg.shape
    E, _, H = w1.shape
    dt = xg.dtype
    xs = _live(xg, rows, E).reshape(E, R // E, D).float()
    dys = _live(dy.to(dt), rows, E).reshape(E, R // E, D).float()
    s3 = s.reshape(E, R // E, H).float()
    dp = torch.einsum("ecd,ehd->ech", dys, w2.float())
    dh = _act_grad(s3, activation) * dp
    dhc = dh.to(dt).float()
    dx = torch.einsum("ech,edh->ecd", dhc, w1.float())
    dw1 = torch.einsum("ecd,ech->edh", xs, dhc)
    db1 = dh.sum(dim=1, keepdim=True)
    dw2 = torch.einsum("ech,ecd->ehd", _act(s3, activation).to(dt).float(), dys)
    db2 = dys.sum(dim=1, keepdim=True)
    return (dx.reshape(R, D).to(dt), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


# -- the CUDA kernels ----------------------------------------------------------


def _check_operands(name, xg, w1, b1, w2, b2, activation):
    """Raise unless the kernels take these operands; returns (E, cap, D, H)."""
    tensors = (xg, w1, b1, w2, b2)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: xg, w1, b1, w2, b2 on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.dtype for t in tensors}) != 1 or xg.dtype not in DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 xg, w1, b1, w2, b2 of one "
                        f"dtype; got {[str(t.dtype) for t in tensors]}")
    if xg.ndim != 2 or w1.ndim != 3:
        raise ValueError(f"{name}: xg must be [E*cap, D] and w1 [E, D, H]; got "
                         f"xg{tuple(xg.shape)} w1{tuple(w1.shape)}")
    R, D = xg.shape
    E, _, H = w1.shape
    cap = R // E if E else 0
    if (R != E * cap or tuple(w1.shape) != (E, D, H) or tuple(b1.shape) != (E, 1, H)
            or tuple(w2.shape) != (E, H, D) or tuple(b2.shape) != (E, 1, D)
            or not moe_kernel_available(E, D, H, cap, xg.dtype, activation, "cuda")):
        raise ValueError(f"{name}: the kernel takes xg [E*cap, D], w1 [E, D, H], b1 [E, 1, H], "
                         f"w2 [E, H, D], b2 [E, 1, D] within its grid (in bf16, D and H "
                         f"multiples of {_TMA_ELEMS}) and an activation in "
                         f"{ACTIVATIONS}; got xg{tuple(xg.shape)} w1{tuple(w1.shape)} "
                         f"b1{tuple(b1.shape)} w2{tuple(w2.shape)} b2{tuple(b2.shape)} "
                         f"{activation!r}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel needs contiguous xg, w1, b1, w2, b2")
    return E, cap, D, H


def _aligned(t):
    """``t``, or one copy of it if its base is off a 16-byte boundary (a
    view into its storage): the kernels read their operands 16 bytes at a
    time (cp.async, TMA). The kernel runs on the copy: no fallback."""
    return t if _cuda.aligned(t) else t.clone()


def _check_rows(name, rows, E, device):
    """``rows`` as a contiguous int32 ``[E]`` tensor on ``device``, or None."""
    if rows is None:
        return None
    if rows.shape != (E,) or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: rows must be an integer [{E}] tensor of live rows per "
                         f"expert; got {rows.dtype} {tuple(rows.shape)}")
    if rows.device != device:
        raise ValueError(f"{name}: rows must lie on the operands' device {device}, "
                         f"not {rows.device}")
    return rows.to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    fn = _cuda.load("moe_grouped_ffn_fwd").moe_grouped_ffn_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = _cuda.load("moe_grouped_ffn_bwd").moe_grouped_ffn_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(xg, w1, b1, w2, b2, activation, rows):
    E, cap, D, H = _check_operands("moe_grouped_ffn_fwd", xg, w1, b1, w2, b2, activation)
    rows = _check_rows("moe_grouped_ffn_fwd", rows, E, xg.device)
    xg, w1, b1, w2, b2 = (_aligned(t) for t in (xg, w1, b1, w2, b2))
    s = torch.empty((E * cap, H), dtype=torch.float32, device=xg.device)
    h = torch.empty((E * cap, H), dtype=xg.dtype, device=xg.device)  # scratch: T(act(s))
    y = torch.empty((E * cap, D), dtype=xg.dtype, device=xg.device)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        rc = _fwd_kernel()(xg.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                           b2.data_ptr(), _ptr(rows), s.data_ptr(), h.data_ptr(), y.data_ptr(),
                           E, cap, D, H, _ACT_CODE[activation], _DTYPE_CODE[xg.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"moe_grouped_ffn_fwd: kernel launch failed with CUDA error {rc}")
    moe_grouped_ffn_fwd.launches += 1
    return y, s


def _launch_bwd(xg, w1, b1, w2, b2, s, dy, activation, rows):
    E, cap, D, H = _check_operands("moe_grouped_ffn_bwd", xg, w1, b1, w2, b2, activation)
    rows = _check_rows("moe_grouped_ffn_bwd", rows, E, xg.device)
    R = E * cap
    if s.device != xg.device or dy.device != xg.device:
        raise ValueError("moe_grouped_ffn_bwd: s and dy must lie on xg's device")
    if s.dtype != torch.float32 or dy.dtype != xg.dtype:
        raise TypeError(f"moe_grouped_ffn_bwd: the kernel takes a float32 s and a dy of xg's dtype "
                        f"{xg.dtype}; got s {s.dtype}, dy {dy.dtype}")
    if tuple(s.shape) != (R, H) or tuple(dy.shape) != (R, D):
        raise ValueError(f"moe_grouped_ffn_bwd: s must be [{R}, {H}] and dy [{R}, {D}]; got "
                         f"s{tuple(s.shape)} dy{tuple(dy.shape)}")
    if not (s.is_contiguous() and dy.is_contiguous()):
        raise ValueError("moe_grouped_ffn_bwd: the kernel needs contiguous s and dy")
    xg, w1, w2, s, dy = (_aligned(t) for t in (xg, w1, w2, s, dy))
    # scratch: dh (f32, for db1), h = T(act(s)), and in bf16 T(dh)
    dh = torch.empty((R, H), dtype=torch.float32, device=xg.device)
    h = torch.empty((R, H), dtype=xg.dtype, device=xg.device)
    dh_t = torch.empty((R, H), dtype=xg.dtype, device=xg.device) if xg.dtype != torch.float32 \
        else None
    dx = torch.empty_like(xg)
    dw1, db1, dw2, db2 = (torch.empty_like(t) for t in (w1, b1, w2, b2))
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        rc = _bwd_kernel()(xg.data_ptr(), w1.data_ptr(), w2.data_ptr(), s.data_ptr(),
                           dy.data_ptr(), _ptr(rows), dh.data_ptr(), _ptr(dh_t), h.data_ptr(),
                           dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
                           db2.data_ptr(), E, cap, D, H, _ACT_CODE[activation],
                           _DTYPE_CODE[xg.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"moe_grouped_ffn_bwd: kernel launch failed with CUDA error {rc}")
    moe_grouped_ffn_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


def moe_grouped_ffn_fwd(xg, w1, b1, w2, b2, activation="gelu", rows=None):
    """K4: ``(y [E*cap, D], s [E*cap, H] f32)`` of the grouped expert FFN
    ``act(xg @ w1[e] + b1[e]) @ w2[e] + b2[e]``, expert ``e = row // cap``.
    ``rows`` (an integer ``[E]`` tensor on xg's device, or None for all
    ``cap``) is each expert's number of live rows; the rest count as the
    zero token: ``s = b1`` and ``y`` the zero token's, whatever xg holds
    there. Launches the CUDA kernel on CUDA tensors (counted in
    ``moe_grouped_ffn_fwd.launches``), the plain version on CPU tensors."""
    if xg.device.type == "cuda":
        return _launch_fwd(xg, w1, b1, w2, b2, activation, rows)
    if xg.device.type != "cpu":
        raise ValueError(f"moe_grouped_ffn_fwd: no kernel for device {xg.device}")
    return _reference_ffn_fwd(xg, w1, b1, w2, b2, activation, rows)


moe_grouped_ffn_fwd.launches = 0


def moe_grouped_ffn_bwd(xg, w1, b1, w2, b2, s, dy, activation="gelu", rows=None):
    """K4b: ``(dx, dw1, db1, dw2, db2)`` of :func:`moe_grouped_ffn_fwd`
    given its residual ``s`` and the output gradient ``dy``; rows past
    ``rows[e]`` have a zero gradient, whatever finite values xg and dy hold
    there (dx = 0 there, and they add nothing to the weights' gradients: the
    weight-gradient products multiply them by zeros, so an inf or NaN there
    would spread). Launches the CUDA
    kernel on CUDA tensors (counted in ``moe_grouped_ffn_bwd.launches``),
    the plain version on CPU tensors."""
    if xg.device.type == "cuda":
        return _launch_bwd(xg, w1, b1, w2, b2, s, dy, activation, rows)
    if xg.device.type != "cpu":
        raise ValueError(f"moe_grouped_ffn_bwd: no kernel for device {xg.device}")
    return _reference_ffn_bwd(xg, w1, b1, w2, b2, s, dy, activation, rows)


moe_grouped_ffn_bwd.launches = 0


class _GroupedFFN(torch.autograd.Function):
    """Counterpart of the reference's ``jax.custom_vjp`` ``_grouped_ffn``:
    the forward runs K4 and saves ``s``, the backward runs K4b."""

    @staticmethod
    def forward(ctx, xg, w1, b1, w2, b2, activation, rows):
        y, s = moe_grouped_ffn_fwd(xg, w1, b1, w2, b2, activation, rows)
        ctx.save_for_backward(xg, w1, b1, w2, b2, s, rows)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        xg, w1, b1, w2, b2, s, rows = ctx.saved_tensors
        grads = moe_grouped_ffn_bwd(xg, w1, b1, w2, b2, s, dy.contiguous(), ctx.activation, rows)
        return (*grads, None, None)


def grouped_ffn(xg, w1, b1, w2, b2, activation="gelu", rows=None):
    """``act(xg @ w1[e] + b1[e]) @ w2[e] + b2[e]`` where ``e = row // cap``
    over the sorted, padded ``[E*cap, D]`` dispatch layout; differentiable
    in all five operands (forward K4, backward K4b). ``rows`` (an integer
    ``[E]`` tensor, or None for all ``cap``) is each expert's number of live
    rows: the rest are the zero token with a zero output gradient, and the
    kernels skip them."""
    return _GroupedFFN.apply(xg, w1, b1, w2, b2, activation, rows)


# -- public op ---------------------------------------------------------------


def sort_pairs(gate_vals, gate_idx, drop_mask, num_experts):
    """The route: the T·K (token, expert) pairs (k-major per token) sorted
    stably by expert id, a pair under ``drop_mask`` past every expert (id
    ``num_experts``). Returns ``(e_sorted, tok_sorted, gv_sorted, counts,
    pos)``: each sorted pair's expert, token and gate value, the pairs per
    expert ``[E + 1]`` (the last: dropped ones) and each sorted pair's queue
    position in its expert, its arrival order."""
    T, K = gate_idx.shape
    E = num_experts
    flat_e = gate_idx.reshape(-1).long()
    if drop_mask is not None:
        # dropped pairs sort past every real expert and never claim a slot
        flat_e = torch.where(drop_mask.reshape(-1), torch.full_like(flat_e, E), flat_e)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = order // K
    gv_sorted = gate_vals.reshape(-1)[order]
    counts = torch.bincount(flat_e, minlength=E + 1)
    starts = torch.cumsum(counts, 0) - counts  # [E+1] run starts
    pos = torch.arange(T * K, device=gate_idx.device) - starts[e_sorted]
    return e_sorted, tok_sorted, gv_sorted, counts, pos


def moe_dispatch_combine(tokens, gate_vals, gate_idx, drop_mask, w1, b1, w2, b2, *, capacity,
                         activation):
    """Sort-based dispatch -> grouped FFN -> weighted combine.

    tokens ``[T, D]``; gate_vals/gate_idx ``[T, K]`` (top-k routing, k-major
    per token); drop_mask ``[T, K]`` bool or None (True: the pair is not
    dispatched, e.g. GShard random routing, and consumes no capacity); w1
    ``[E, D, H]``, b1 ``[E, 1, H]``, w2 ``[E, H, D]``, b2 ``[E, 1, D]``;
    ``activation`` one of :data:`ACTIVATIONS`. ``capacity`` is the
    per-expert token budget; overflow drops in arrival order, exactly as the
    dense composite. Returns ``[T, D]``.
    """
    T, D = tokens.shape
    E = w1.shape[0]
    cap = int(capacity)
    device = tokens.device

    e_sorted, tok_sorted, gv_sorted, counts, pos = sort_pairs(gate_vals, gate_idx, drop_mask, E)
    keep = (e_sorted < E) & (pos < cap)
    slot = torch.where(keep, e_sorted * cap + pos, torch.full_like(pos, E * cap))

    # dispatch: one scatter of token ids, one gather of token rows (slot
    # E*cap and token row T are the write-off lanes for dropped pairs)
    row_ids = torch.full((E * cap + 1,), T, dtype=torch.long, device=device)
    row_ids.scatter_(0, slot, tok_sorted)
    xg = torch.cat([tokens, tokens.new_zeros((1, D))]).index_select(0, row_ids[:E * cap])

    # the live rows of each expert: the kernels read them on the device
    rows = counts[:E].clamp(max=cap).to(torch.int32)
    yg = grouped_ffn(xg, w1, b1, w2, b2, activation, rows)

    # combine: weighted scatter-add back to token order. On the card
    # index_add (and the backward of each index_select) accumulates with
    # atomics: for K <= 2 each token row receives at most two nonzero
    # addends onto zero (the rest are exact zeros: padding rows' and dropped
    # pairs' gradients), so the sum is exact in any order; K > 2 is not
    # bit-stable from run to run. (Indexing with a tensor would take
    # PyTorch's sort-based backward instead, which serialises the many
    # repeats of the write-off indices.)
    weights = torch.where(keep, gv_sorted, torch.zeros_like(gv_sorted))
    gathered = yg.index_select(0, torch.where(keep, slot, torch.zeros_like(slot)))
    gathered = gathered * weights[:, None].to(yg.dtype)
    return torch.zeros((T, D), dtype=yg.dtype, device=device).index_add(0, tok_sorted, gathered)


registry.define_kernel("moe")
registry.register(
    "moe", "pallas_sorted", moe_dispatch_combine, available=moe_available,
    doc="sort-based dispatch + grouped-FFN CUDA kernels K4/K4b (plain versions on the CPU)")
