"""Functionals of the port (``paddle_tpu.nn.functional``)."""
from .activation import *  # noqa: F401,F403
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (alpha_dropout, bilinear, cosine_similarity, dropout, dropout2d,  # noqa: F401
                     dropout3d, embedding, interpolate, label_smooth, linear, normalize, one_hot,
                     pad, unfold, upsample)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,  # noqa: F401
                   conv3d_transpose)
from .extension_ops import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,  # noqa: F401
                   local_response_norm, rms_norm, sync_batch_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,  # noqa: F401
                      adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d, max_pool3d)
from .sequence import *  # noqa: F401,F403
