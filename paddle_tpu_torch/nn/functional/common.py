"""``linear`` and ``embedding`` of the port (``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...framework.selected_rows import in_compiled_step


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` with the reference's ``[in, out]`` weight; in an
    ``auto_cast`` scope all three run in its dtype (the ``linear`` op)."""
    if bias is None:
        x, weight = cast_inputs("linear", x, weight)
        return x @ weight
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return x @ weight + bias


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
