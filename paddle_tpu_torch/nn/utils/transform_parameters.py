"""Parameters <-> one flat vector — port of
``paddle_tpu/nn/utils/transform_parameters.py``. Neither records a
gradient (Paddle runs both under ``no_grad``)."""
from __future__ import annotations

import torch

from ...framework.tensor import wrap
from ...ops.dispatch import plain

__all__ = ["parameters_to_vector", "vector_to_parameters"]


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and joined, in order."""
    parameters = list(parameters)
    if not parameters:
        raise ValueError("parameters_to_vector got an empty parameter list")
    with torch.no_grad():
        return wrap(torch.cat([plain(p).detach().reshape(-1)
                               for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into the parameters, in place
    (each in its own dtype)."""
    parameters = list(parameters)
    v = plain(vec) if isinstance(vec, torch.Tensor) else torch.as_tensor(vec)
    total = sum(p.numel() for p in parameters)
    if v.numel() != total:
        raise ValueError(f"vector has {v.numel()} elements but parameters "
                         f"need {total}")
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(v[offset:offset + n].reshape(p.shape))
            offset += n
