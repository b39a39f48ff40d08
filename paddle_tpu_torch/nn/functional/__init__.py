"""Functionals of the port (``paddle_tpu/nn/functional``: the serving and
training subset)."""
from .activation import gelu, softmax  # noqa: F401
from .attention import LengthMask, scaled_dot_product_attention  # noqa: F401
from .common import embedding, linear, matmul  # noqa: F401
from .norm import layer_norm  # noqa: F401
from ...ops.fused import fused_linear_cross_entropy  # noqa: F401
