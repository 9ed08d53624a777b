"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``. ``None`` means the CUDA card: with no
    CUDA device that raises, and the port never drops to the CPU unless the
    caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
