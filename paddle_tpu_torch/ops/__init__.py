"""The op surface of the port and the Tensor methods — port of
``paddle_tpu/ops/__init__.py``.

:mod:`.cuda` holds the hand-written Hopper kernels; the op modules
(:mod:`.creation`, :mod:`.math`, :mod:`.manipulation`, :mod:`.logic`,
:mod:`.linalg`, :mod:`.search`, :mod:`.stat`, :mod:`.einsum`,
:mod:`.random`) hold ``paddle.*``'s tensor functions, which are installed
as methods of :class:`~paddle_tpu_torch.framework.tensor.Tensor` (over
torch's methods of the same name), with the in-place variants and the
operators, as the JAX package patches its Tensor.
"""
from __future__ import annotations

import types as _types

import torch as _torch

from ..framework.tensor import Tensor, check_inplace as _check_inplace
from .dispatch import (OP_REGISTRY, apply_nondiff_op, ensure_tensor,  # noqa: F401
                       op)
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from . import random  # noqa: F401
from .random import (  # noqa: F401
    bernoulli,
    multinomial,
    normal,
    poisson,
    rand,
    randint,
    randint_like,
    randn,
    randperm,
    standard_normal,
    uniform,
)
from . import creation, linalg, logic, manipulation  # noqa: F401
from . import math, search, stat  # noqa: F401

_TB = _torch._C.TensorBase

# --------------------------------------------------------------------------
# Tensor methods: every public function of the op modules, over torch's
# method of the same name, unless the Tensor class defines the name itself
# --------------------------------------------------------------------------

_METHODS = {}
for _mod in (creation, math, manipulation, logic, linalg, search, stat):
    for _name in dir(_mod):
        if _name.startswith("_") or not _name[0].islower():
            continue
        _fn = getattr(_mod, _name)
        if callable(_fn) and not isinstance(_fn, (type, _types.ModuleType)):
            _METHODS.setdefault(_name, _fn)
_METHODS["einsum"] = einsum
for _name in ("uniform_", "normal_", "exponential_", "bernoulli",
              "multinomial"):
    _METHODS[_name] = getattr(random, _name)

_SKIP = {"is_tensor", "create_parameter", "meshgrid", "broadcast_tensors",
         "ensure_tensor", "op", "operand", "dims", "reduce", "plain",
         "scalar_like", "apply_nondiff_op", "wrap", "to_tensor",
         "check_inplace", "current_device"}
for _name, _fn in _METHODS.items():
    if _name in _SKIP or _name in Tensor.__dict__:
        continue
    setattr(Tensor, _name, _fn)

Tensor.pow = lambda self, y: math.pow_(self, y)
Tensor.mean = math.mean
Tensor.scale = math.scale
Tensor.add_n = lambda self, xs: add_n([self] + list(xs))


def add_n(inputs, name=None):
    """``paddle.add_n``: the sum of a list of tensors."""
    if isinstance(inputs, _torch.Tensor):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = math.add(out, t)
    return out


def _make_inplace(fn):
    def inplace(self, *a, **k):
        _check_inplace(self)
        out = fn(self, *a, **k)
        _TB.copy_(self, out.as_subclass(_torch.Tensor))
        return self

    inplace.__name__ = fn.__name__ + "_"
    return inplace


for _n, _f in (
    ("add_", math.add),
    ("subtract_", math.subtract),
    ("multiply_", math.multiply),
    ("divide_", math.divide),
    ("clip_", math.clip),
    ("scale_", math.scale),
    ("floor_", math.floor),
    ("ceil_", math.ceil),
    ("exp_", math.exp),
    ("sqrt_", math.sqrt),
    ("rsqrt_", math.rsqrt),
    ("reciprocal_", math.reciprocal),
    ("round_", math.round),
    ("tanh_", math.tanh),
    ("abs_", math.abs),
    ("remainder_", math.remainder),
    ("pow_", math.pow_),
):
    setattr(Tensor, _n, _make_inplace(_f))


def fill_(x, value):
    _check_inplace(x)
    _TB.fill_(x, value)
    return x


def zero_(x):
    return fill_(x, 0)


Tensor.fill_ = fill_
Tensor.zero_ = zero_

# ---------------------------------------------------------------- dunders ---


def _reflected(fn):
    def r(x, y):
        return fn(math.operand(y, x), x)

    return r


def _cmp_or_none(fn, none):
    def cmp(x, y):
        if y is None:
            return none
        return fn(x, y)

    return cmp


_BINOPS = {
    "__add__": math.add,
    "__radd__": _reflected(math.add),
    "__sub__": math.subtract,
    "__rsub__": _reflected(math.subtract),
    "__mul__": math.multiply,
    "__rmul__": _reflected(math.multiply),
    "__truediv__": math.divide,
    "__rtruediv__": _reflected(math.divide),
    "__floordiv__": math.floor_divide,
    "__rfloordiv__": _reflected(math.floor_divide),
    "__mod__": math.remainder,
    "__rmod__": _reflected(math.remainder),
    "__pow__": math.pow_,
    "__rpow__": _reflected(math.pow_),
    "__matmul__": math.matmul,
    "__rmatmul__": _reflected(math.matmul),
    "__eq__": _cmp_or_none(math.equal, False),
    "__ne__": _cmp_or_none(math.not_equal, True),
    "__lt__": math.less_than,
    "__le__": math.less_equal,
    "__gt__": math.greater_than,
    "__ge__": math.greater_equal,
    "__and__": logic.bitwise_and,
    "__or__": logic.bitwise_or,
    "__xor__": logic.bitwise_xor,
}
for _n, _f in _BINOPS.items():
    setattr(Tensor, _n, _f)

Tensor.__neg__ = math.neg
Tensor.__abs__ = math.abs
Tensor.__invert__ = logic.bitwise_not
Tensor.__hash__ = _torch.Tensor.__hash__

del _n, _f, _name, _fn, _mod
