"""Micro-batching of the port (``paddle_tpu/distributed/pipeline.py``):
the strided split that gradient accumulation shares with the pipeline
schedule of the reference. The pipeline itself is not ported yet
(ROADMAP.md, Queue 1 item 13)."""
from __future__ import annotations

import torch


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """``[B, ...] -> [n_micro, B / n_micro, ...]`` with micro-batch i the
    rows ``i::n_micro`` (strided, as in the reference: GPT-MoE's capacity is
    computed per micro-batch, so a contiguous split would route
    differently)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return x.reshape(b // n_micro, n_micro, *x.shape[1:]).transpose(0, 1)


def unmicrobatch(xm: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`microbatch`."""
    n_micro, mb = xm.shape[0], xm.shape[1]
    return xm.transpose(0, 1).reshape(n_micro * mb, *xm.shape[2:])
