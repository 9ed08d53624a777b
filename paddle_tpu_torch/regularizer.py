"""``paddle.regularizer`` of the port (``paddle_tpu/regularizer.py``):
``L1Decay`` and ``L2Decay``, taken as an optimizer's ``weight_decay``. The
optimizer adds ``coeff * sign(p)`` (L1) or ``coeff * p`` (L2) to each
gradient (:mod:`paddle_tpu_torch.optimizer.optimizer`)."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self._regularization_coeff = self.coeff  # the reference's attribute name

    def __float__(self):
        return self.coeff

    def __repr__(self):
        return f"L2Decay({self.coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self._regularization_coeff = self.coeff

    def __float__(self):
        return self.coeff

    def __repr__(self):
        return f"L1Decay({self.coeff})"
