"""Common functionals of the port (``paddle_tpu/nn/functional/common.py``):
``linear``, the dropouts, ``embedding``, ``one_hot``, ``label_smooth``,
``pad``, ``normalize``, ``cosine_similarity``, ``bilinear``,
``interpolate``/``upsample`` and ``unfold``.

Every dropout draws its keep mask through :func:`dropout_mask`, from the
generator it is given or, without one, from the next key of the current
random stream (:func:`paddle_tpu_torch.framework.random.split_key`: a
``TrainStep``'s per-step stream, else the global one). Dropout runs outside
every kernel, as the reference's does: the mask is ``torch.rand`` against
the keep probability, the scaling a ``torch.where``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...framework import random as _random
from ...framework.selected_rows import in_compiled_step


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` with the reference's ``[in, out]`` weight; in an
    ``auto_cast`` scope all three run in its dtype (the ``linear`` op)."""
    if bias is None:
        x, weight = cast_inputs("linear", x, weight)
        return x @ weight
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return x @ weight + bias


# -- dropout ---------------------------------------------------------------------
def dropout_mask(shape, p, generator=None, device=None):
    """The keep mask of one dropout site: a bool tensor of ``shape``, True
    with probability ``1 - p``, drawn from ``generator`` (the reference's
    ``jax.random.bernoulli(key, 1 - p, shape)``). Every dropout of the port
    draws through this function."""
    return torch.rand(tuple(shape), generator=generator, device=device) < 1.0 - p


def _draw(shape, p, generator, device):
    if generator is None:
        generator = _random.next_generator(device)
    return _random.site_mask(shape, p, generator, device)


def _scalar(value, like):
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None,
            generator=None):
    """Drop entries with probability ``p``. ``axis`` (an int or a list): the
    dims the mask spans, the others broadcast (a whole channel drops at
    once). ``mode="upscale_in_train"`` scales the kept entries by
    ``1 / (1 - p)`` in training and is the identity in eval;
    ``"downscale_in_infer"`` keeps them as they are in training and scales
    by ``1 - p`` in eval. ``generator`` draws the mask (default: the current
    stream)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or 'downscale_in_infer', "
                         f"got {mode!r}")
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * _scalar(1.0 - p, x)
    axes = None if axis is None else (list(axis) if isinstance(axis, (list, tuple)) else [axis])
    shape = tuple(x.shape) if axes is None else tuple(
        s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = _draw(shape, p, generator, x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x * _scalar(1.0 / (1.0 - p), x) if p < 1.0 else zero, zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, generator=None):
    """Whole channels of a 4-D input dropped (the mask spans N and C)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, generator=None):
    """Whole channels of a 5-D input dropped (the mask spans N and C)."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's dropout: dropped entries take SELU's negative saturation
    ``-alpha * scale``, then an affine map ``a x + b`` with the reference's
    constants restores the mean and variance. The identity in eval."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _draw(tuple(x.shape), p, generator, x.device)
    a = 1.0 / (_SELU_SCALE * ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    out = a * torch.where(keep, x, _scalar(alpha_p, x)) + b
    return out.to(x.dtype)


# -- lookups ---------------------------------------------------------------------
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row lookup with the reference's explicit out-of-range semantics.

    Outside a ``TrainStep`` an out-of-range id raises ``ValueError`` naming
    the id and its flat position (a host sync, as the reference's eager
    check); inside one (:func:`~paddle_tpu_torch.framework.selected_rows.in_compiled_step`)
    it gives the zero row, and its gradient adds exactly zero to the
    clamped row. ``padding_idx`` rows give zeros and get no gradient.
    ``sparse`` is taken for the reference's signature: the layer records
    the rows."""
    v = weight.shape[0]
    bad = (x < 0) | (x >= v)
    if not in_compiled_step() and bool(bad.any()):
        pos = int(bad.reshape(-1).to(torch.int8).argmax())
        offender = int(x.reshape(-1)[pos])
        raise ValueError(f"embedding(): id {offender} at flat position {pos} is "
                         f"out of range [0, {v}) for a {v}-row table")
    out = torch.where(bad[..., None], 0.0, F.embedding(x.clamp(0, v - 1), weight))
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def one_hot(x, num_classes, name=None):
    """f32 ``[..., num_classes]`` one-hot rows of the integer ``x``."""
    return F.one_hot(x.long(), num_classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) label + epsilon prior`` (uniform ``1 / k`` without
    ``prior_dist``)."""
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


# -- shapes ----------------------------------------------------------------------
_PAD_MODES = ("constant", "reflect", "replicate", "circular")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad: ``2 * ndim`` values pad every dim, first dim first;
    fewer pad the spatial dims from the LAST one (``[left, right, top,
    bottom, front, back]``: W, then H, then D for a channels-first layout;
    a channels-last one skips the channel dim)."""
    nd = x.ndim
    pad = [int(p) for p in pad]
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode must be one of {sorted(_PAD_MODES)}, got {mode!r}")
    cfg = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        last = nd - 1 if data_format.startswith("NC") else nd - 2
        for i in range(len(pad) // 2):
            cfg[last - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [v for lo_hi in reversed(cfg) for v in lo_hi]  # torch: last dim first
        return F.pad(x, flat, mode="constant", value=value)
    # torch pads only trailing spatial dims in these modes: move the padded
    # dims to the back, pad, and move them back
    dims = [d for d in range(nd) if cfg[d] != (0, 0)]
    rest = [d for d in range(nd) if cfg[d] == (0, 0)]
    perm = rest + dims
    y = x.permute(perm)
    lead = y.shape[:len(rest)]
    y = y.reshape((1, -1) + tuple(y.shape[len(rest):]))
    flat = [v for d in reversed(dims) for v in cfg[d]]
    if len(dims) > 3:
        raise NotImplementedError(f"pad: mode {mode!r} over more than 3 dims")
    y = F.pad(y, flat, mode=mode)
    y = y.reshape(tuple(lead) + tuple(y.shape[2:]))
    return y.permute([perm.index(d) for d in range(nd)])


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p over axis, epsilon)``."""
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``<x1, x2> / max(||x1|| ||x2||, eps)`` over ``axis``."""
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] (+ bias[o])``, W ``[out, in1, in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


# -- resizing --------------------------------------------------------------------
def _linear_kernel(x):
    return torch.clamp(1.0 - x, min=0.0)


def _cubic_kernel(x):  # Keys' cubic, a = -0.5
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(m, n, kernel, device):
    """The ``[m, n]`` resampling matrix of one dim from ``m`` to ``n``
    points, antialiased when shrinking (the reference's resize)."""
    inv = 1.0 / torch.tensor(n / m, dtype=torch.float32)
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32)[:, None]).abs() / kscale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize(v, out_shape, method):
    """``v`` resampled to ``out_shape`` over the dims whose sizes change:
    nearest takes the half-pixel-centred source, linear and cubic contract
    each dim with its resampling matrix."""
    dims = [d for d in range(v.ndim) if v.shape[d] != out_shape[d]]
    if method == "nearest":
        for d in dims:
            m, n = v.shape[d], out_shape[d]
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).long()
            v = v.index_select(d, idx.to(v.device))
        return v
    kernel = _linear_kernel if method == "linear" else _cubic_kernel
    y = v if v.is_floating_point() else v.float()
    for d in dims:
        w = _weight_mat(v.shape[d], out_shape[d], kernel, v.device).to(y.dtype)
        y = torch.tensordot(y, w, dims=([d], [0])).movedim(-1, d)
    return y


_RESIZE_METHOD = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
                  "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                data_format="NCHW", name=None):
    """Resize the spatial dims to ``size`` (or by ``scale_factor``), with
    the reference's resampling (half-pixel centres, antialiased when
    shrinking; ``align_corners`` is taken for the signature, as there)."""
    channels_first = data_format.startswith("NC")
    spatial = x.shape[2:] if channels_first else x.shape[1:-1]
    if size is not None:
        out_sp = [int(s) for s in (size if isinstance(size, (list, tuple)) else [size] * len(spatial))]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else [scale_factor] * len(spatial)
        out_sp = [int(s * f) for s, f in zip(spatial, sf)]
    out_shape = ((*x.shape[:2], *out_sp) if channels_first
                 else (x.shape[0], *out_sp, x.shape[-1]))
    return _resize(x, out_shape, _RESIZE_METHOD[mode])


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` -> ``[N, C * kh * kw, L]``, channel-major
    patches (``paddings``: one value, or ``[ph, pw]`` applied to both
    sides)."""
    ks, st, pd, dl = _pair(kernel_sizes), _pair(strides), _pair(paddings), _pair(dilations)
    return F.unfold(x, kernel_size=ks, dilation=dl, padding=pd[:2], stride=st)


__all__ = ["linear", "dropout_mask", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "normalize", "cosine_similarity",
           "bilinear", "interpolate", "upsample", "unfold"]
