"""Training step of the port (the ported part of ``paddle_tpu.jit``):
``TrainStep`` and the ``MultiStepRunner`` loop."""
from .train_step import MultiStepRunner, TrainStep  # noqa: F401
