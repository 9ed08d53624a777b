"""Gradient clipping of the port (``paddle_tpu/nn/clip.py``): the global-norm
clip that GPT pretraining uses. The by-value and by-norm clips are not ported
yet (ROADMAP.md, Queue 1 item 7)."""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / max(norm, 1e-12))``, the
    norm taken in f32 over all of them.

    A non-finite global norm makes the scale non-finite, so every clipped
    gradient PROPAGATES as NaN, as in the reference: the clip never hides a
    blown-up step by scaling it down."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = clip_norm

    def apply_list(self, grads):
        """The clipped gradients, in their own dtypes (new tensors)."""
        total = sum(g.float().square().sum() for g in grads)
        scale = (self.clip_norm / torch.sqrt(total).clamp(min=1e-12)).clamp(max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]
