"""Training and evaluation steps of the port (the ported part of
``paddle_tpu.jit``): ``TrainStep``, the ``MultiStepRunner`` loop and
``EvalStep``."""
from .eval_step import EvalStep  # noqa: F401
from .train_step import MultiStepRunner, TrainStep  # noqa: F401
