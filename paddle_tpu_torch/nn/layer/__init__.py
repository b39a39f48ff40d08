"""Layers of the port, on :class:`~.layers.Layer` (a ``torch.nn.Module``
with Paddle's surface). ``Linear`` (``common.py``) and the conv layers
(``conv.py``) keep the JAX package's initializers and run through the
port's functionals; ``Sequential``, ``LayerList``, ``ParameterList`` and
``LayerDict`` are Paddle's containers (``container.py``)."""
from .activation import ReLU  # noqa: F401
from .common import Linear  # noqa: F401
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layers import Layer, ParamAttr  # noqa: F401
from .loss import CrossEntropyLoss, L1Loss, MSELoss  # noqa: F401
from .norm import (  # noqa: F401
    BatchNorm,
    BatchNorm1D,
    BatchNorm2D,
    BatchNorm3D,
    LayerNorm,
)
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D,
    AdaptiveAvgPool2D,
    AdaptiveAvgPool3D,
    AdaptiveMaxPool2D,
    AvgPool1D,
    AvgPool2D,
    AvgPool3D,
    MaxPool1D,
    MaxPool2D,
    MaxPool3D,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
