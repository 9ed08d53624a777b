"""``embedding`` of the port (``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework.selected_rows import in_compiled_step


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
