"""Functionals of the port (the ported subset of ``paddle_tpu.nn.functional``)."""
from .activation import gelu, relu  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm  # noqa: F401
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d  # noqa: F401
