"""The functional tail of the port (``paddle_tpu/nn/functional/extension_ops.py``):
pixel and channel shuffles, ``zeropad2d``, ``diag_embed``,
``temporal_shift``, ``affine_grid``, ``grid_sample``, ``fold``,
``max_unpool1d/2d/3d``, ``gather_tree``, ``class_center_sample`` and
``sparse_attention``.

Each is the reference's composition in plain tensor ops; no TPU kernel is
involved. Where the reference differs from a torch op of the same name,
the function keeps the reference's semantics and its docstring says how.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .pooling import _pair

__all__ = [
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "zeropad2d",
    "diag_embed", "temporal_shift", "affine_grid", "grid_sample", "fold",
    "max_unpool1d", "max_unpool2d", "max_unpool3d", "gather_tree",
    "class_center_sample", "sparse_attention",
]


def _nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(x, data_format):
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[n, c r^2, h, w]`` -> ``[n, c, h r, w r]`` (``NHWC`` too)."""
    r = int(upscale_factor)
    v = _nchw(x, data_format)
    n, c, h, w = v.shape
    v = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return _back(v.reshape(n, c // (r * r), h * r, w * r), data_format)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """:func:`pixel_shuffle`'s inverse."""
    r = int(downscale_factor)
    v = _nchw(x, data_format)
    n, c, h, w = v.shape
    v = v.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return _back(v.reshape(n, c * r * r, h // r, w // r), data_format)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """The channels as ``[groups, c / groups]`` transposed (ShuffleNet)."""
    g = int(groups)
    v = _nchw(x, data_format)
    n, c, h, w = v.shape
    v = v.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)
    return _back(v, data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zeros around the spatial dims; ``padding`` is ``[left, right, top,
    bottom]`` or one int for all four."""
    left, right, top, bottom = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    if data_format == "NCHW":
        return F.pad(x, (left, right, top, bottom))
    return F.pad(x, (0, 0, left, right, top, bottom))


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    """Each last-dim vector of ``x`` as the ``offset``-th diagonal of a
    square ``[m, m]`` matrix (``m = n + |offset|``), the two new dims then
    moved to ``dim1`` and ``dim2`` of the result (the reference's
    ``moveaxis`` of the trailing pair, which for positive dims places them
    as ``torch.diag_embed`` does)."""
    out = torch.diag_embed(x, offset=offset, dim1=-2, dim2=-1)
    if (dim1, dim2) == (-2, -1):
        return out
    return torch.movedim(out, (-2, -1), (dim1, dim2))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW", name=None):
    """TSM: the first ``c * shift_ratio`` channels shifted one segment
    back in time, the next as many one forward, zeros where they leave."""
    v = _nchw(x, data_format)
    nt, c, h, w = v.shape
    n = nt // seg_num
    v = v.reshape(n, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], dim=1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], dim=1)
    out = torch.cat([back, fwd, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return _back(out, data_format)


def _lin(size, align_corners, device):
    if align_corners:
        return torch.linspace(-1.0, 1.0, size, device=device)
    step = 2.0 / size
    return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, device=device)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[n, 2, 3]`` affine parameters -> the ``[n, h, w, 2]`` sampling grid,
    computed in f32 and given in ``theta``'s dtype. The reference's default
    is ``align_corners=True`` (torch's is False)."""
    _, _, h, w = [int(d) for d in out_shape]
    ys, xs = torch.meshgrid(_lin(h, align_corners, theta.device),
                            _lin(w, align_corners, theta.device), indexing="ij")
    base = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # [h, w, 3]
    return torch.einsum("hwk,nck->nhwc", base, theta.float()).to(theta.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True, name=None):
    """``[n, c, h, w]`` sampled at the normalised ``[n, gh, gw, 2]`` grid,
    ``bilinear`` or ``nearest`` (round half to even), padding ``zeros`` or
    ``border``. The reference's default is ``align_corners=True``; its
    ``border`` clamps each corner's index, not the sampling coordinate, and
    its ``reflection`` is not there."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(mode)
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(f"padding_mode {padding_mode!r}")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]  # [n, gh, gw, c]
        if padding_mode == "zeros":
            vals = torch.where(inb[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                                 device=vals.device))
        return vals

    if mode == "nearest":
        out = gather(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
        out = (gather(x0, y0) * (1 - wx) * (1 - wy) + gather(x0 + 1, y0) * wx * (1 - wy)
               + gather(x0, y0 + 1) * (1 - wx) * wy + gather(x0 + 1, y0 + 1) * wx * wy)
    return out.to(x.dtype).permute(0, 3, 1, 2)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """col2im: ``[n, c kh kw, L]`` patches -> ``[n, c, H, W]``, overlaps
    added. ``paddings`` is one int or ``[ph, pw]``."""
    H, W = _pair(output_sizes, 2, "output_sizes")
    kh, kw = _pair(kernel_sizes, 2, "kernel_sizes")
    sh, sw = _pair(strides, 2, "strides")
    ph, pw = _pair(paddings, 2, "paddings")
    dh, dw = _pair(dilations, 2, "dilations")
    ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    v = x.reshape(n, c, kh, kw, ho, wo)
    out = x.new_zeros((n, c, H + 2 * ph, W + 2 * pw))
    for i in range(kh):
        for j in range(kw):
            ys, xs = i * dh, j * dw
            out[:, :, ys:ys + sh * ho:sh, xs:xs + sw * wo:sw] += v[:, :, i, j]
    return out[:, :, ph:ph + H, pw:pw + W]


def _max_unpool(x, indices, n, kernel_size, stride, padding, output_size):
    """The pooled values scattered back to the flat positions ``indices``
    recorded (``return_mask=True`` pooling); zeros elsewhere. As in the
    reference, ``data_format`` is not read."""
    ks = _pair(kernel_size, n, "kernel_size")
    st = _pair(stride if stride is not None else kernel_size, n, "stride")
    pd = _pair(padding, n, "padding")
    if output_size is not None:
        out_sp = [int(d) for d in list(output_size)[-n:]]
    else:
        out_sp = [(x.shape[2 + i] - 1) * st[i] - 2 * pd[i] + ks[i] for i in range(n)]
    N, C = x.shape[:2]
    flat = x.new_zeros((N, C, math.prod(out_sp)))
    flat = flat.scatter(2, indices.reshape(N, C, -1).long(), x.reshape(N, C, -1))
    return flat.reshape(N, C, *out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0, data_format="NCDHW",
                 output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding, output_size)


def gather_tree(ids, parents, name=None):
    """Beam search's parent pointers traced back into whole sequences:
    ``ids`` and ``parents`` ``[T, batch, beam]``; step ``t`` of beam ``k``
    is the token of the beam that beam ``k``'s line held at ``t``."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(ids.shape[1:]).contiguous()
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.gather(ids[t], -1, beams))
        beams = torch.gather(parents[t], -1, beams)
    return torch.stack(toks[::-1])


def class_center_sample(label, num_classes, num_samples, group=None, generator=None):
    """PartialFC's sampled class centres: every positive class of ``label``
    and negatives drawn without replacement up to ``num_samples`` (at
    least the positives), sorted; returns ``(the labels remapped into the
    sample, the sampled class indices)``. The negatives come from
    ``generator`` (a ``numpy.random.Generator``; None: fresh entropy each
    call, as the reference's). The reference ignores ``group`` and samples
    this rank's labels alone; the port raises for a group instead
    (ROADMAP.md, "Faults in the reference")."""
    if group is not None:
        raise NotImplementedError(
            "class_center_sample over a group: the reference ignores the group and samples "
            "this rank's labels alone (ROADMAP.md, 'Faults in the reference')")
    lab = label.detach().cpu().numpy().ravel()
    pos = np.unique(lab)
    num_samples = max(int(num_samples), len(pos))
    neg_pool = np.setdiff1d(np.arange(num_classes), pos)
    rng = generator if generator is not None else np.random.default_rng()
    extra = rng.choice(neg_pool, size=min(num_samples - len(pos), len(neg_pool)), replace=False)
    sampled = np.sort(np.concatenate([pos, extra]))
    remap = {c: i for i, c in enumerate(sampled)}
    new_lab = np.asarray([remap[c] for c in lab], np.int64)
    return (torch.from_numpy(new_lab).to(label.device),
            torch.from_numpy(sampled.astype(np.int64)).to(label.device))


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns, name=None):
    """Attention ``[b, h, s, d]`` over the CSR layout given: the reference
    reads ONE layout for every batch and head (the first row of the
    offsets, the first ``offsets[-1]`` columns), builds the dense ``[s, s]``
    connectivity and masks the other scores to -1e30, softmax in f32."""
    b, h, s, d = query.shape
    off = sparse_csr_offset.reshape(-1, sparse_csr_offset.shape[-1])[0].long()
    cols = sparse_csr_columns
    cols = (cols.reshape(-1)[:int(off[-1])] if cols.ndim > 1 else cols).long()
    rows = torch.repeat_interleave(torch.arange(s, device=query.device), off[1:] - off[:-1])
    mask = torch.zeros((s, s), dtype=torch.bool, device=query.device)
    mask[rows, cols] = True
    logits = query.float() @ key.float().transpose(-1, -2) / math.sqrt(d)
    logits = logits.masked_fill(~mask, -1e30)
    return (torch.softmax(logits, dim=-1) @ value.float()).to(query.dtype)
