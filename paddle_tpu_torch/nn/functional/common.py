"""Common functionals — port of ``paddle_tpu/nn/functional/common.py``
(``linear`` and ``embedding``) and of ``paddle_tpu/ops/math.py::matmul``, in
plain PyTorch.

``linear`` takes Paddle's ``[in, out]`` weight and computes ``x @ weight +
bias``, as the JAX package does (torch's own ``linear`` runs on the
weight's transposed view, so cuBLAS reads ``[in, out]`` as it is stored and
adds the bias in its epilogue). Operands of two float dtypes promote as in JAX
(bf16 against fp32 computes in fp32), where torch's own products would
refuse them; ``amp.auto_cast`` casts the inputs first by the JAX op names
``linear`` and ``matmul``.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast

__all__ = ["linear", "matmul", "embedding"]


def _promoted(a, b):
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``."""
    x, weight, bias = _amp_cast("linear", x, weight, bias)
    x, weight = _promoted(x, weight)
    if bias is None or bias.dtype == x.dtype:
        return torch.nn.functional.linear(x, weight.t(), bias)
    # JAX adds the bias to the product in the promoted dtype of the two
    return torch.nn.functional.linear(x, weight.t()) + bias


def _swap_last(t):
    return t.transpose(-1, -2) if t.ndim >= 2 else t


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``paddle.matmul``: ``transpose_x`` / ``transpose_y`` swap the last two
    axes of an operand of two or more dims first; ``name`` is accepted and
    ignored, as in the JAX package."""
    x, y = _amp_cast("matmul", x, y)
    if transpose_x:
        x = _swap_last(x)
    if transpose_y:
        y = _swap_last(y)
    return torch.matmul(*_promoted(x, y))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``. The rows at ``padding_idx`` (in
    ``[-vocab, vocab)``; a negative one counts from the end) are zeros, and
    so is their gradient, as in the JAX package. ``sparse`` gives the same
    gradient, stored dense (the JAX package gives a row-sparse one)."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is None:
        return out
    pi = padding_idx if padding_idx >= 0 else padding_idx + weight.shape[0]
    return out * (x != pi).unsqueeze(-1).to(out.dtype)
