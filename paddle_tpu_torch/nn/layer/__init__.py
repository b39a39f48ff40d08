"""Layers of the port, on :class:`~.layers.Layer` (a ``torch.nn.Module``
with Paddle's surface). ``Linear`` (``common.py``), the conv layers
(``conv.py``) and the norm layers keep the JAX package's initializers,
take a ``ParamAttr`` and run through the port's functionals (the
activation, dropout, common, pooling and loss layers too);
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict`` are
Paddle's containers (``container.py``)."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .conv import *  # noqa: F401,F403
from .layers import Layer, ParamAttr  # noqa: F401
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .transformer import (  # noqa: F401
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
