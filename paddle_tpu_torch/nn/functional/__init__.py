"""Functionals of the port (``paddle_tpu/nn/functional``: the serving,
training, encoder and vision subset, the activations, dropouts, padding,
resampling and rearrangements, the convolutions and their transposes, the
pools, norms and losses, the sampling grids, ``sequence_mask`` and
``sparse_attention``; what still waits is listed in
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
from . import sequence as _sequence
from . import sparse_attention as _sparse_attention
from . import vision as _vision
from .attention import LengthMask  # noqa: F401
from ...ops import fused as _fused

_NAMES = {
    _activation: tuple(_activation.__all__),
    _attention: ("flash_attention", "scaled_dot_product_attention"),
    _common: tuple(_common.__all__),
    _conv: tuple(_conv.__all__),
    _loss: tuple(_loss.__all__),
    _norm: tuple(_norm.__all__),
    _pooling: tuple(_pooling.__all__),
    _sequence: ("sequence_mask",),
    _sparse_attention: ("sparse_attention",),
    _vision: ("affine_grid", "grid_sample"),
    _fused: ("fused_linear_cross_entropy",),
}
for _mod, _names in _NAMES.items():
    for _name in _names:
        # the in-place forms take and give back the caller's Tensor itself
        _fn = getattr(_mod, _name)
        globals()[_name] = _fn if _name.endswith("_") else _api(_fn)

__all__ = ["LengthMask"] + [n for names in _NAMES.values() for n in names]
del _mod, _names, _name, _fn
