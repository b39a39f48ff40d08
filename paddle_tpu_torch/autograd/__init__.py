"""``paddle.autograd`` of the port: ``backward``, ``grad``, the grad-mode
guards and ``PyLayer``, on ``torch.autograd``."""
from .engine import (  # noqa: F401
    backward,
    enable_grad,
    grad,
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
