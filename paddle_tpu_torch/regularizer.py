"""Regularizers (reference ``python/paddle/fluid/regularizer.py``;
applied by folding into grads before the optimizer update).

A copy of ``paddle_tpu/regularizer.py``, which imports no JAX. An
optimizer's ``weight_decay`` or a parameter's ``regularizer`` attribute
takes them (``optimizer/optimizer.py``).
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


class L1Decay(WeightDecayRegularizer):
    pass


class L2Decay(WeightDecayRegularizer):
    pass
