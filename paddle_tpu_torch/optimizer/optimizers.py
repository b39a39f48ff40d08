"""Concrete optimizers — port of ``paddle_tpu.optimizer.optimizers``.

SGD, Momentum (with Nesterov), Adam, AdamW, Adamax, Adagrad, Adadelta,
RMSProp (with ``centered``) and Lamb, with the JAX package's accumulator
names, fills and update rules. As there, the Adam family keeps its bias
corrections in beta-power accumulators (``beta1_pow``, ``beta2_pow``, 0-d,
in the value's dtype), not a step index, and AdamW scales the base value
(the fp32 master under multi_precision) by ``1 - lr * weight_decay``
before the Adam step.

Every rule is written as the JAX expression with its promotions spelled
out (see :mod:`.optimizer`): ``lr`` is an fp32 0-d tensor, an operand it
meets is widened with ``.float()``, and Python constants go through
``self._c`` against low-precision values.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)

    def _update_param(self, key, value, grad, lr):
        return value.float() - lr * grad.float()


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update_param(self, key, value, grad, lr):
        c = self._c
        v = self._add_accumulator("velocity", key, value)
        v_new = c(self._momentum, v) * v + grad
        self._set_accumulator("velocity", key, v_new)
        if self._use_nesterov:
            step = grad + c(self._momentum, v_new) * v_new
            return value.float() - lr * step.float()
        return value.float() - lr * v_new.float()


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update_param(self, key, value, grad, lr):
        c, b1, b2 = self._c, self._beta1, self._beta2
        m = self._add_accumulator("moment1", key, value)
        v = self._add_accumulator("moment2", key, value)
        b1p = self._add_accumulator("beta1_pow", key, value, 1.0, shape=())
        b2p = self._add_accumulator("beta2_pow", key, value, 1.0, shape=())
        b1p = b1p * c(b1, b1p)
        b2p = b2p * c(b2, b2p)
        m_new = c(b1, m) * m + c(1 - b1, grad) * grad
        v_new = c(b2, v) * v + c(1 - b2, grad) * torch.square(grad)
        m_hat = m_new / (1 - b1p)
        v_hat = v_new / (1 - b2p)
        self._set_accumulator("moment1", key, m_new)
        self._set_accumulator("moment2", key, v_new)
        self._set_accumulator("beta1_pow", key, b1p)
        self._set_accumulator("beta2_pow", key, b2p)
        denom = torch.sqrt(v_hat) + c(self._epsilon, v_hat)
        return value.float() - lr * m_hat.float() / denom.float()


class AdamW(Adam):
    """Decoupled weight decay. A ``weight_decay`` that is not a float means
    0.01, as in the JAX package; ``apply_decay_param_fun(param_key)``
    chooses the parameters that decay (all of them by default)."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision=multi_precision,
                         name=name)
        self._wd_coeff = (weight_decay if isinstance(weight_decay, float)
                          else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_param(self, key, value, grad, lr):
        if (self._apply_decay_param_fun is None
                or self._apply_decay_param_fun(key)):
            value = value.float() * (1.0 - lr * self._wd_coeff)
        return super()._update_param(key, value, grad, lr)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, key, value, grad, lr):
        c, b1 = self._c, self._beta1
        m = self._add_accumulator("moment", key, value)
        u = self._add_accumulator("inf_norm", key, value)
        b1p = self._add_accumulator("beta1_pow", key, value, 1.0, shape=())
        b1p = b1p * c(b1, b1p)
        m_new = c(b1, m) * m + c(1 - b1, grad) * grad
        u_new = torch.maximum(c(self._beta2, u) * u, torch.abs(grad))
        self._set_accumulator("moment", key, m_new)
        self._set_accumulator("inf_norm", key, u_new)
        self._set_accumulator("beta1_pow", key, b1p)
        denom = u_new + c(self._epsilon, u_new)
        return (value.float()
                - lr / (1 - b1p).float() * m_new.float() / denom.float())


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, key, value, grad, lr):
        acc = self._add_accumulator("moment", key, value, self._init_acc)
        acc_new = acc + torch.square(grad)
        self._set_accumulator("moment", key, acc_new)
        denom = torch.sqrt(acc_new) + self._c(self._epsilon, acc_new)
        return value.float() - lr * grad.float() / denom.float()


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _update_param(self, key, value, grad, lr):
        c, rho, eps = self._c, self._rho, self._epsilon
        avg_sq = self._add_accumulator("avg_squared_grad", key, value)
        avg_up = self._add_accumulator("avg_squared_update", key, value)
        avg_sq_new = c(rho, avg_sq) * avg_sq + c(1 - rho, grad) * torch.square(grad)
        update = -torch.sqrt((avg_up + c(eps, avg_up))
                             / (avg_sq_new + c(eps, avg_sq_new))) * grad
        avg_up_new = (c(rho, avg_up) * avg_up
                      + c(1 - rho, update) * torch.square(update))
        self._set_accumulator("avg_squared_grad", key, avg_sq_new)
        self._set_accumulator("avg_squared_update", key, avg_up_new)
        return value.float() + lr * update.float()


class RMSProp(Optimizer):
    """As in the JAX package, ``momentum`` is born in the value's dtype and
    comes back fp32 from its first update (``lr * grad`` is fp32)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_param(self, key, value, grad, lr):
        c, rho, eps = self._c, self._rho, self._epsilon
        ms = self._add_accumulator("mean_square", key, value)
        mom = self._add_accumulator("momentum", key, value)
        ms_new = c(rho, ms) * ms + c(1 - rho, grad) * torch.square(grad)
        self._set_accumulator("mean_square", key, ms_new)
        if self._centered:
            mg = self._add_accumulator("mean_grad", key, value)
            mg_new = c(rho, mg) * mg + c(1 - rho, grad) * grad
            self._set_accumulator("mean_grad", key, mg_new)
            inner = ms_new - torch.square(mg_new)
        else:
            inner = ms_new
        denom = torch.sqrt(inner + c(eps, inner))
        mom_new = (c(self._momentum, mom) * mom).float() + (
            lr * grad.float() / denom.float())
        self._set_accumulator("momentum", key, mom_new)
        return value.float() - mom_new


class Lamb(Optimizer):
    """``exclude_from_weight_decay_fn(param)`` gets the parameter itself,
    as in the JAX package."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn
        self._by_key = {self._pkey(p): p for p in self._parameter_list}

    def _update_param(self, key, value, grad, lr):
        c, b1, b2 = self._c, self._beta1, self._beta2
        m = self._add_accumulator("moment1", key, value)
        v = self._add_accumulator("moment2", key, value)
        b1p = self._add_accumulator("beta1_pow", key, value, 1.0, shape=())
        b2p = self._add_accumulator("beta2_pow", key, value, 1.0, shape=())
        b1p = b1p * c(b1, b1p)
        b2p = b2p * c(b2, b2p)
        m_new = c(b1, m) * m + c(1 - b1, grad) * grad
        v_new = c(b2, v) * v + c(1 - b2, grad) * torch.square(grad)
        self._set_accumulator("moment1", key, m_new)
        self._set_accumulator("moment2", key, v_new)
        self._set_accumulator("beta1_pow", key, b1p)
        self._set_accumulator("beta2_pow", key, b2p)
        m_hat = m_new / (1 - b1p)
        v_hat = v_new / (1 - b2p)
        r = m_hat / (torch.sqrt(v_hat) + c(self._epsilon, v_hat))
        excluded = (self._exclude_fn is not None
                    and self._exclude_fn(self._by_key[key]))
        wd = 0.0 if excluded else self._wd
        update = r + c(wd, r) * value
        # jnp.linalg.norm: squares in the value's dtype, then their sum
        w_norm = torch.sqrt(torch.sum(torch.square(value)))
        u_norm = torch.sqrt(torch.sum(torch.square(update)))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            c(1.0, w_norm))
        return value.float() - lr * trust.float() * update.float()
