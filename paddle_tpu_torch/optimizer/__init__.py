"""Optimizers of the port (the ported subset of ``paddle_tpu.optimizer``)."""
from . import functional  # noqa: F401
from . import lr  # noqa: F401
from .optimizer import AdamW, Momentum, Optimizer  # noqa: F401
