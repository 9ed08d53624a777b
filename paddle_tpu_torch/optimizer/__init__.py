"""Optimizers of the port (``paddle_tpu.optimizer``)."""
from . import functional  # noqa: F401
from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum,  # noqa: F401
                        Optimizer, RMSProp, RowSparseAdam)
