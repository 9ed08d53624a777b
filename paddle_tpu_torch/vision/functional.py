"""Image functionals of the port (``paddle_tpu/vision/functional.py``;
parity: python/paddle/vision/transforms/functional.py and
functional_tensor.py), op for op the reference's.

Host-side numpy image ops: transforms run in the input pipeline (DataLoader
workers), never on the card, as the reference's cv2/PIL backends do.
Images are HWC numpy arrays (uint8 or float) or CHW torch tensors; every op
gives back the container it was given (a tensor on its own device). A
forked process worker may run them: a CPU tensor stays on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def _as_np(img):
    """``(array, the tensor it came from or None)``."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy(), img
    return np.asarray(img), None


def _back(arr, like):
    if like is not None:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    return arr


def to_tensor(pic, data_format="CHW"):
    """HWC uint8/float image -> float32 CPU tensor scaled to [0, 1]
    (reference functional.to_tensor)."""
    arr = np.asarray(pic)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if data_format == "CHW":
        arr = np.transpose(arr, (2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))


def hflip(img):
    arr, like = _as_np(img)
    t = like is not None
    return _back(arr[..., ::-1] if t else arr[:, ::-1], like)


def vflip(img):
    arr, like = _as_np(img)
    t = like is not None
    return _back(arr[..., ::-1, :] if t else arr[::-1], like)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr, like = _as_np(img)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    shape = (-1, 1, 1) if data_format == "CHW" else (1, 1, -1)
    out = (arr.astype(np.float32) - mean.reshape(shape)) / std.reshape(shape)
    return _back(out, like)


def crop(img, top, left, height, width):
    arr, like = _as_np(img)
    t = like is not None
    if t:  # CHW
        return _back(arr[..., top:top + height, left:left + width], like)
    return _back(arr[top:top + height, left:left + width], like)


def center_crop(img, output_size):
    arr, like = _as_np(img)
    t = like is not None
    oh, ow = (output_size, output_size) if isinstance(output_size, int) else output_size
    h, w = (arr.shape[-2], arr.shape[-1]) if t else (arr.shape[0], arr.shape[1])
    top = max((h - oh) // 2, 0)
    left = max((w - ow) // 2, 0)
    return crop(img, top, left, oh, ow)


def resize(img, size, interpolation="bilinear"):
    """Nearest/bilinear resize on the host (reference functional.resize).
    ``size``: int (short side) or (h, w)."""
    arr, like = _as_np(img)
    t = like is not None
    chw = t
    a = np.transpose(arr, (1, 2, 0)) if chw else arr
    if a.ndim == 2:
        a = a[:, :, None]
    h, w = a.shape[:2]
    if isinstance(size, int):
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    if interpolation == "nearest":
        yi = (np.arange(oh) * h / oh).astype(int).clip(0, h - 1)
        xi = (np.arange(ow) * w / ow).astype(int).clip(0, w - 1)
        out = a[yi][:, xi]
    else:  # bilinear
        fy = (np.arange(oh) + 0.5) * h / oh - 0.5
        fx = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.floor(fy).astype(int).clip(0, h - 1)
        x0 = np.floor(fx).astype(int).clip(0, w - 1)
        y1 = (y0 + 1).clip(0, h - 1)
        x1 = (x0 + 1).clip(0, w - 1)
        wy = (fy - y0).clip(0, 1)[:, None, None]
        wx = (fx - x0).clip(0, 1)[None, :, None]
        af = a.astype(np.float32)
        out = (af[y0][:, x0] * (1 - wy) * (1 - wx) + af[y0][:, x1] * (1 - wy) * wx
               + af[y1][:, x0] * wy * (1 - wx) + af[y1][:, x1] * wy * wx)
        if arr.dtype == np.uint8:
            out = np.round(out).clip(0, 255).astype(np.uint8)
        else:
            out = out.astype(arr.dtype)
    out = np.squeeze(out, -1) if (not chw and arr.ndim == 2) else out
    return _back(np.transpose(out, (2, 0, 1)) if chw else out, like)


def pad(img, padding, fill=0, padding_mode="constant"):
    arr, like = _as_np(img)
    t = like is not None
    if isinstance(padding, int):
        l = r = tp = b = padding
    elif len(padding) == 2:
        (l, tp), (r, b) = (padding[0], padding[1]), (padding[0], padding[1])
    else:
        l, tp, r, b = padding
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if padding_mode == "constant" else {}
    if t:  # CHW
        pads = [(0, 0)] * (arr.ndim - 2) + [(tp, b), (l, r)]
    else:
        pads = [(tp, b), (l, r)] + [(0, 0)] * (arr.ndim - 2)
    return _back(np.pad(arr, pads, mode=mode, **kw), like)


def adjust_brightness(img, brightness_factor):
    arr, like = _as_np(img)
    out = arr.astype(np.float32) * brightness_factor
    out = out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out.astype(arr.dtype)
    return _back(out, like)


def adjust_contrast(img, contrast_factor):
    arr, like = _as_np(img)
    t = like is not None
    gray_mean = _gray(arr, t).mean()
    out = arr.astype(np.float32) * contrast_factor + gray_mean * (1 - contrast_factor)
    out = out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out.astype(arr.dtype)
    return _back(out, like)


def _gray(arr, chw):
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    a = arr.astype(np.float32)
    if chw:
        return np.tensordot(w, a, axes=([0], [0]))
    return a @ w


def to_grayscale(img, num_output_channels=1):
    arr, like = _as_np(img)
    t = like is not None
    g = _gray(arr, t)
    if t:
        out = np.repeat(g[None], num_output_channels, 0)
    else:
        out = np.repeat(g[..., None], num_output_channels, -1)
    out = out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out.astype(arr.dtype)
    return _back(out, like)


def adjust_saturation(img, saturation_factor):
    arr, like = _as_np(img)
    t = like is not None
    g = _gray(arr, t)
    g = g[None] if t else g[..., None]
    out = arr.astype(np.float32) * saturation_factor + g * (1 - saturation_factor)
    out = out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out.astype(arr.dtype)
    return _back(out, like)


def adjust_hue(img, hue_factor):
    """Rotate hue by hue_factor (in [-0.5, 0.5]) via RGB<->HSV
    (reference functional.adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr, like = _as_np(img)
    t = like is not None
    a = (np.moveaxis(arr, 0, -1) if t else arr).astype(np.float32)
    scale = 255.0 if arr.dtype == np.uint8 else 1.0
    a = a / scale
    mx, mn = a.max(-1), a.min(-1)
    d = mx - mn + 1e-8
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    h = np.where(mx == r, ((g - b) / d) % 6, np.where(mx == g, (b - r) / d + 2, (r - g) / d + 4)) / 6
    h = (h + hue_factor) % 1.0
    s = np.where(mx > 0, d / (mx + 1e-8), 0)
    v = mx
    i = np.floor(h * 6)
    f = h * 6 - i
    p, q, tt = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = i.astype(int) % 6
    conds = [(i == k)[..., None] for k in range(6)]
    out = np.select(conds,
                    [np.stack([v, tt, p], -1), np.stack([q, v, p], -1), np.stack([p, v, tt], -1),
                     np.stack([p, q, v], -1), np.stack([tt, p, v], -1), np.stack([v, p, q], -1)])
    out = out * scale
    out = out.clip(0, 255).astype(np.uint8) if arr.dtype == np.uint8 else out.astype(arr.dtype)
    return _back(np.moveaxis(out, -1, 0) if t else out, like)


def erase(img, i, j, h, w, v, inplace=False):
    arr, like = _as_np(img)
    t = like is not None
    # a tensor's numpy view is a copy on the host: true in-place only works
    # for writable ndarrays
    out = arr if (inplace and not t and arr.flags.writeable) else arr.copy()
    if t:
        out[..., i:i + h, j:j + w] = v
    else:
        out[i:i + h, j:j + w] = v
    return _back(out, like)


def _affine_sample(arr, chw, mat, out_hw, interpolation="nearest", fill=0):
    """Inverse-map sampling with a 2x3 matrix in pixel coords; nearest or
    bilinear interpolation."""
    a = np.moveaxis(arr, 0, -1) if chw else arr
    squeeze = a.ndim == 2
    if squeeze:
        a = a[:, :, None]
    H, W = out_hw
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    sx = mat[0, 0] * xs + mat[0, 1] * ys + mat[0, 2]
    sy = mat[1, 0] * xs + mat[1, 1] * ys + mat[1, 2]

    def gather(yi, xi):
        inb = (xi >= 0) & (xi < a.shape[1]) & (yi >= 0) & (yi < a.shape[0])
        vals = a[yi.clip(0, a.shape[0] - 1), xi.clip(0, a.shape[1] - 1)].astype(np.float32)
        return np.where(inb[..., None], vals, np.float32(fill))

    if interpolation == "bilinear":
        x0 = np.floor(sx).astype(int)
        y0 = np.floor(sy).astype(int)
        wx = (sx - x0)[..., None]
        wy = (sy - y0)[..., None]
        out = (gather(y0, x0) * (1 - wy) * (1 - wx) + gather(y0, x0 + 1) * (1 - wy) * wx
               + gather(y0 + 1, x0) * wy * (1 - wx) + gather(y0 + 1, x0 + 1) * wy * wx)
    else:
        out = gather(np.round(sy).astype(int), np.round(sx).astype(int))
    if arr.dtype == np.uint8:
        out = np.round(out).clip(0, 255).astype(np.uint8)
    else:
        out = out.astype(arr.dtype)
    if squeeze:
        out = out[:, :, 0]
    return np.moveaxis(out, -1, 0) if chw else out


def rotate(img, angle, interpolation="nearest", expand=False, center=None, fill=0):
    arr, like = _as_np(img)
    t = like is not None
    h, w = (arr.shape[-2:] if t else arr.shape[:2])
    rad = np.deg2rad(angle)
    c, s = np.cos(rad), np.sin(rad)
    oh, ow = h, w
    if expand:
        # canvas grows to hold the rotated extent; rotation recentered
        ow = int(np.ceil(round(abs(w * c) + abs(h * s), 10)))
        oh = int(np.ceil(round(abs(w * s) + abs(h * c), 10)))
        center = None  # expand always rotates about the image center
    cx, cy = center if center is not None else (w / 2, h / 2)
    ocx, ocy = (ow / 2, oh / 2) if expand else (cx, cy)
    # inverse rotation: output pixel -> source pixel about the centers
    mat = np.array([[c, s, cx - c * ocx - s * ocy],
                    [-s, c, cy + s * ocx - c * ocy]], np.float32)
    return _back(_affine_sample(arr, t, mat, (oh, ow), interpolation, fill), like)


def affine(img, angle=0, translate=(0, 0), scale=1.0, shear=(0, 0), interpolation="nearest", center=None, fill=0):
    arr, like = _as_np(img)
    t = like is not None
    h, w = (arr.shape[-2:] if t else arr.shape[:2])
    cx, cy = center if center is not None else (w / 2, h / 2)
    rad = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    # forward matrix R(angle) @ Shear @ scale, then invert for sampling
    a = scale * np.cos(rad + sy) / max(np.cos(sy), 1e-8)
    b = scale * (np.cos(rad + sy) * np.tan(sx) / max(np.cos(sy), 1e-8) - np.sin(rad))
    c = scale * np.sin(rad + sy) / max(np.cos(sy), 1e-8)
    d = scale * (np.sin(rad + sy) * np.tan(sx) / max(np.cos(sy), 1e-8) + np.cos(rad))
    fwd = np.array([[a, b, 0.0], [c, d, 0.0], [0, 0, 1.0]], np.float32)
    inv = np.linalg.inv(fwd)
    tx, ty = translate
    mat = np.array([[inv[0, 0], inv[0, 1], 0], [inv[1, 0], inv[1, 1], 0]], np.float32)
    mat[:, 2] = [cx - mat[0, 0] * (cx + tx) - mat[0, 1] * (cy + ty),
                 cy - mat[1, 0] * (cx + tx) - mat[1, 1] * (cy + ty)]
    return _back(_affine_sample(arr, t, mat, (h, w), interpolation, fill), like)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """Four-point perspective warp (reference functional.perspective)."""
    arr, like = _as_np(img)
    t = like is not None
    h, w = (arr.shape[-2:] if t else arr.shape[:2])
    # solve homography mapping endpoints -> startpoints (inverse sampling)
    A, bvec = [], []
    for (ex, ey), (sx, sy) in zip(endpoints, startpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        bvec.append(sx)
        A.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        bvec.append(sy)
    hvec = np.linalg.solve(np.asarray(A, np.float64), np.asarray(bvec, np.float64))
    Hm = np.append(hvec, 1.0).reshape(3, 3)
    a = np.moveaxis(arr, 0, -1) if t else arr
    squeeze = a.ndim == 2
    if squeeze:
        a = a[:, :, None]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    den = Hm[2, 0] * xs + Hm[2, 1] * ys + Hm[2, 2]
    sxs = (Hm[0, 0] * xs + Hm[0, 1] * ys + Hm[0, 2]) / den
    sys_ = (Hm[1, 0] * xs + Hm[1, 1] * ys + Hm[1, 2]) / den
    xi, yi = np.round(sxs).astype(int), np.round(sys_).astype(int)
    inb = (xi >= 0) & (xi < a.shape[1]) & (yi >= 0) & (yi < a.shape[0])
    out = np.full((h, w, a.shape[2]), fill, a.dtype)
    out[inb] = a[yi.clip(0, a.shape[0] - 1), xi.clip(0, a.shape[1] - 1)][inb]
    if squeeze:
        out = out[:, :, 0]
    return _back(np.moveaxis(out, -1, 0) if t else out, like)
