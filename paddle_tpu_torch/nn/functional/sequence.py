"""``sequence_mask`` — port of ``paddle_tpu/nn/functional/sequence.py``
(``viterbi_decode`` there waits with the text models, ``ROADMAP.md`` A10)."""
from __future__ import annotations

import torch

from ...framework import dtype as dtypes
from ...framework.tensor import wrap
from ...ops.dispatch import plain

__all__ = ["sequence_mask"]


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < lengths[...]`` over ``maxlen`` columns (None:
    the largest length), in ``dtype``; no gradient."""
    lv = plain(lengths) if isinstance(lengths, torch.Tensor) else \
        torch.as_tensor(lengths)
    m = int(maxlen) if maxlen is not None else int(lv.max())
    mask = torch.arange(m, device=lv.device) < lv.unsqueeze(-1)
    return wrap(mask.to(dtypes.convert_dtype(dtype)))
