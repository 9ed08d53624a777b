"""Layers of the port with the reference's names, layouts and default
initialisers (``paddle_tpu/nn/layer/``)."""
from .common import Embedding, Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401
