"""Functionals of the port (``paddle_tpu/nn/functional``: the serving,
training, encoder and vision subset)."""
from .activation import gelu, relu, softmax  # noqa: F401
from .attention import (  # noqa: F401
    LengthMask,
    flash_attention,
    scaled_dot_product_attention,
)
from .common import embedding, linear, matmul  # noqa: F401
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm, layer_norm  # noqa: F401
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d,
    adaptive_avg_pool2d,
    adaptive_avg_pool3d,
    adaptive_max_pool2d,
    avg_pool1d,
    avg_pool2d,
    avg_pool3d,
    max_pool1d,
    max_pool2d,
    max_pool3d,
)
from ...ops.fused import fused_linear_cross_entropy  # noqa: F401
