"""Int8 weight quantization of the port (``paddle_tpu/quantization``): the
symmetric abs_max quantizer the serving engine's ``int8=True`` applies to
the stacked trunk weights. The post-training and quantization-aware layers
of the reference are not ported (ROADMAP.md, Queue 1 item 14)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["quant_abs_max"]


def quant_abs_max(w, channel_axis=None):
    """int8 symmetric quantization of ``w`` (numpy or a tensor). Per channel
    when ``channel_axis`` is given (the reference's channel_wise_abs_max),
    else per tensor. A tuple ``channel_axis`` keeps one scale per index
    along EVERY listed axis: ``(0, 2)`` over an ``[L, in, out]`` stack gives
    per-layer x per-output-channel scales. Returns ``(int8 array, f32 scale
    broadcastable against w)`` as numpy arrays."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    if channel_axis is None:
        scale = np.asarray(np.maximum(np.abs(w).max(), 1e-8) / 127.0, np.float32)
    else:
        keep = (channel_axis,) if isinstance(channel_axis, int) else tuple(channel_axis)
        keep = tuple(a % w.ndim for a in keep)
        axes = tuple(i for i in range(w.ndim) if i not in keep)
        scale = np.maximum(np.abs(w).max(axis=axes, keepdims=True), 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)
