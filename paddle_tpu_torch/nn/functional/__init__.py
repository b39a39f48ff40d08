"""Functionals of the port (``paddle_tpu/nn/functional``: the serving,
training, encoder and vision subset, the activations, dropouts, common
functionals and losses; what still waits is listed in
``tests/test_torch_api_coverage.py::F_WAITING``).

The functions here take Paddle Tensors as well as plain torch tensors
(``framework.tensor.api``): given a Tensor, they hand torch plain views and
give back Tensors; given plain tensors only (as the port's own layers and
models call them), they run as they are after one scan of the arguments.
"""
from ...framework.tensor import api as _api
from . import activation as _activation
from . import attention as _attention
from . import common as _common
from . import conv as _conv
from . import loss as _loss
from . import norm as _norm
from . import pooling as _pooling
from .attention import LengthMask  # noqa: F401
from ...ops import fused as _fused

_NAMES = {
    _activation: tuple(_activation.__all__),
    _attention: ("flash_attention", "scaled_dot_product_attention"),
    _common: tuple(_common.__all__),
    _conv: ("conv1d", "conv2d", "conv3d"),
    _loss: tuple(_loss.__all__),
    _norm: ("batch_norm", "layer_norm", "normalize"),
    _pooling: ("adaptive_avg_pool1d", "adaptive_avg_pool2d",
               "adaptive_avg_pool3d", "adaptive_max_pool2d", "avg_pool1d",
               "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
               "max_pool3d"),
    _fused: ("fused_linear_cross_entropy",),
}
for _mod, _names in _NAMES.items():
    for _name in _names:
        # the in-place forms take and give back the caller's Tensor itself
        _fn = getattr(_mod, _name)
        globals()[_name] = _fn if _name.endswith("_") else _api(_fn)

__all__ = ["LengthMask"] + [n for names in _NAMES.values() for n in names]
del _mod, _names, _name, _fn
