"""``paddle_tpu_torch.nn``: functionals, layers (the activation and loss
layers among them), containers, initializers, gradient clipping and
``utils`` (the weight- and spectral-norm hooks, the parameter-vector
transforms)."""
from . import functional, initializer, utils  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .layer.activation import *  # noqa: F401,F403
from .layer.loss import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer import (  # noqa: F401
    Layer,
    LayerDict,
    LayerList,
    MultiHeadAttention,
    ParamAttr,
    ParameterList,
    Sequential,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
