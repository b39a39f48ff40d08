"""Adam and AdamW — port of ``paddle_tpu.optimizer.optimizers``.

As in the JAX package (and the reference), the bias corrections come from
beta-power accumulators (``beta1_pow``, ``beta2_pow``, 0-d, in the value's
dtype), not from a step index, and AdamW scales the base value (the fp32
master under multi_precision) by ``1 - lr * weight_decay`` before the Adam
step.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, name,
                         multi_precision=multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update_param(self, key, value, grad, lr):
        m = self._add_accumulator("moment1", key, value)
        v = self._add_accumulator("moment2", key, value)
        b1p = self._add_accumulator("beta1_pow", key, value, 1.0, shape=())
        b2p = self._add_accumulator("beta2_pow", key, value, 1.0, shape=())
        b1p.copy_(b1p * self._beta1)
        b2p.copy_(b2p * self._beta2)
        m.copy_(self._beta1 * m + (1 - self._beta1) * grad)
        v.copy_(self._beta2 * v + (1 - self._beta2) * torch.square(grad))
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        return value - lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)


class AdamW(Adam):
    """Decoupled weight decay. A ``weight_decay`` that is not a float means
    0.01, as in the JAX package; ``apply_decay_param_fun(param_key)``
    chooses the parameters that decay (all of them by default)."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, multi_precision=multi_precision, name=name)
        self._wd_coeff = (weight_decay if isinstance(weight_decay, float)
                          else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_param(self, key, value, grad, lr):
        if (self._apply_decay_param_fun is None
                or self._apply_decay_param_fun(key)):
            value = value * (1.0 - lr * self._wd_coeff)
        return super()._update_param(key, value, grad, lr)
