"""Op dispatch — port of ``paddle_tpu/ops/dispatch.py``.

An op is a function of plain torch tensors declared with :func:`op`. Its
wrapper does what the JAX package's ``apply_op`` does, less the tape:

* casts the positional tensor inputs by the op's JAX name through the
  port's ``amp.auto_cast`` lists (white list to the low-precision dtype at
  O1, black list to fp32);
* hands torch plain views of every tensor argument (Tensors, Parameters and
  plain tensors alike) and gives the result back as Tensors;
* under ``FLAGS_check_nan_inf``, raises if a floating output holds Inf/NaN.

There is no VJP to record: torch records the gradient of what the op runs.
``STATIC_RECORDER`` (the static Program) waits for ``ROADMAP.md`` A10.
"""
from __future__ import annotations

import functools
import importlib

import torch

from ..amp.auto_cast import cast_inputs as _amp_cast
from ..framework.flags import _REGISTRY as _FLAGS
from ..framework.tensor import _unwrap_tree, to_tensor, unwrap, wrap

__all__ = ["OP_REGISTRY", "op", "apply_op", "apply_nondiff_op",
           "ensure_tensor", "scalar_like", "plain"]

OP_REGISTRY = {}

_NAN_FLAG = _FLAGS["check_nan_inf"]
# the module (``amp.auto_cast`` is also the context manager's name)
_amp = importlib.import_module("..amp.auto_cast", __package__)


#: ``x`` for torch: a plain view of a tensor, anything else unchanged
plain = unwrap


def _check_nan_inf(name, out):
    outs = out if isinstance(out, (tuple, list)) else [out]
    for o in outs:
        if (isinstance(o, torch.Tensor) and o.is_floating_point()
                and not bool(torch.isfinite(o).all())):
            raise FloatingPointError(
                f"Operator {name} output contains Inf/Nan "
                f"(FLAGS_check_nan_inf is set).")


def apply_op(name, fwd, args, kwargs, amp=True):
    """Run ``fwd`` on plain views of ``args``/``kwargs`` and wrap what it
    returns."""
    vals = [_unwrap_tree(a) for a in args]
    if amp and _amp._policy is not None:
        vals = list(_amp_cast(name, *vals))
    kw = {k: _unwrap_tree(v) for k, v in kwargs.items()}
    out = fwd(*vals, **kw)
    if _NAN_FLAG.value:
        _check_nan_inf(name, out)
    return wrap(out)


def apply_nondiff_op(name, fwd, args, static_kwargs=None):
    """Dispatch of an op with bool/int outputs: no amp policy (comparisons
    are dtype-neutral), no gradient."""
    vals = [_unwrap_tree(a) for a in args]
    return wrap(fwd(*vals, **(static_kwargs or {})))


def op(name=None, nondiff=False):
    """Declare an op from a forward on plain torch tensors; its positional
    arguments may be Tensors, its keyword arguments are attributes."""

    def deco(fwd):
        opname = name or fwd.__name__

        @functools.wraps(fwd)
        def wrapper(*args, **kwargs):
            return apply_op(opname, fwd, args, kwargs, amp=not nondiff)

        wrapper.raw = fwd
        wrapper.op_name = opname
        OP_REGISTRY[opname] = wrapper
        return wrapper

    return deco


def scalar_like(v, like):
    """A Python scalar as JAX applies it to an array like ``like``: in
    ``like``'s dtype (a 0-d CPU tensor, which torch takes beside a tensor on
    any device)."""
    return torch.tensor(v, dtype=like.dtype)


def ensure_tensor(x, dtype=None, like=None):
    """A tensor of ``x``: Python scalars take the dtype of ``like`` (as the
    JAX package casts them), arrays land on the current place."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None and isinstance(x, (int, float, bool)):
        return wrap(scalar_like(x, like))
    return to_tensor(x, dtype=dtype)

