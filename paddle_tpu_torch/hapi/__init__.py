"""hapi's high-level API in the port (``paddle_tpu/hapi``; parity:
python/paddle/hapi): ``Model``, the callbacks and ``flops``."""
from . import callbacks  # noqa: F401
from .dynamic_flops import flops  # noqa: F401
from .model import Model  # noqa: F401
