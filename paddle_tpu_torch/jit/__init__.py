"""Training step of the port (the ported part of ``paddle_tpu.jit``)."""
from .train_step import TrainStep  # noqa: F401
