"""``paddle_tpu_torch.nn``: functionals, layers and gradient clipping."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .layer import (  # noqa: F401
    LayerNorm,
    Linear,
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
