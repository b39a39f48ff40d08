"""Functionals of the port (``paddle_tpu/nn/functional``: the serving and
training subset)."""
from .activation import gelu, relu, softmax  # noqa: F401
from .attention import (  # noqa: F401
    LengthMask,
    flash_attention,
    scaled_dot_product_attention,
)
from .common import embedding, linear, matmul  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
from ...ops.fused import fused_linear_cross_entropy  # noqa: F401
