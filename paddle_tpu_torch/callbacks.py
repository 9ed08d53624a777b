"""``paddle.callbacks`` of the port (``paddle_tpu/callbacks.py``; reference
python/paddle/callbacks/__init__.py): hapi's callback protocol."""
from .hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    MetricsLogger,
    ModelCheckpoint,
    ProgBarLogger,
    TrainingHealth,
)
