"""Layers of the port. ``Linear`` (``common.py``) keeps the JAX package's
initializer and runs through the port's ``F.linear``; Embedding and
LayerList of the JAX package are ``torch.nn.Embedding``/``ModuleList``."""
from .common import Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
