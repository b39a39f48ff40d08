"""Logical and bitwise ops — port of ``paddle_tpu/ops/logic.py``."""
from __future__ import annotations

import torch

from ..framework.tensor import Tensor
from .dispatch import apply_nondiff_op
from .math import operand


def _logic(opname, fn):
    def api(x, y=None, out=None, name=None):
        if y is None:
            return apply_nondiff_op(opname, fn, (x,))
        return apply_nondiff_op(opname, fn, (x, operand(y, x)))

    api.__name__ = opname
    api.op_name = opname
    return api


logical_and = _logic("logical_and", torch.logical_and)
logical_or = _logic("logical_or", torch.logical_or)
logical_xor = _logic("logical_xor", torch.logical_xor)
logical_not = _logic("logical_not", torch.logical_not)
bitwise_and = _logic("bitwise_and", torch.bitwise_and)
bitwise_or = _logic("bitwise_or", torch.bitwise_or)
bitwise_xor = _logic("bitwise_xor", torch.bitwise_xor)
bitwise_not = _logic("bitwise_not", torch.bitwise_not)


def is_tensor(x):
    return isinstance(x, Tensor)
