"""einsum — port of ``paddle_tpu/ops/einsum.py`` (``torch.einsum``)."""
from __future__ import annotations

import torch

from .dispatch import op


@op("einsum")
def _einsum_raw(*operands, equation=None):
    return torch.einsum(equation, *operands)


def einsum(equation, *operands):
    if not isinstance(equation, str):
        raise TypeError("first argument must be the equation string")
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return _einsum_raw(*operands, equation=equation)
