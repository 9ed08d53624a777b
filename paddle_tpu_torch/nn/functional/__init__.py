"""Functionals of the port (the ported subset of ``paddle_tpu.nn.functional``)."""
from .activation import *  # noqa: F401,F403
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (alpha_dropout, bilinear, cosine_similarity, dropout, dropout2d,  # noqa: F401
                     dropout3d, embedding, interpolate, label_smooth, linear, normalize, one_hot,
                     pad, unfold, upsample)
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .extension_ops import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import batch_norm, sync_batch_norm  # noqa: F401
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d  # noqa: F401
from .sequence import *  # noqa: F401,F403
