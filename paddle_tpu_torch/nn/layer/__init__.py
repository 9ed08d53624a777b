"""Layers of the port with the reference's names, layouts and default
initialisers (``paddle_tpu/nn/layer/``). ``paddle.nn.Sequential`` is
``torch.nn.Sequential``, which names its children ``"0"``, ``"1"``, ... as
the reference's does."""
from .activation import ReLU  # noqa: F401
from .common import Embedding, Linear  # noqa: F401
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm,  # noqa: F401
                   SyncBatchNorm)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D  # noqa: F401
