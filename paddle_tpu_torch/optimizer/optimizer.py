"""Optimizer base — port of ``paddle_tpu.optimizer.optimizer``.

Each optimizer's update rule is plain tensor code over (value, grad,
accumulators), run once a parameter per :meth:`Optimizer.step`, in the JAX
package's order: collect the gradients, clip them (``grad_clip``), take the
learning rate (a float or an :class:`~.lr.LRScheduler`, times the
parameter's ``optimize_attr["learning_rate"]``), fold in the parameter's
``regularizer`` or the optimizer's ``weight_decay``, then update.
Accumulators live in ``self._accumulators[name][param_key]`` and are created
at first use, in the dtype of the value being updated. Parameters are keyed
by name: ``param_<i>`` in the order given (what the JAX package's names are
when a model is built under a fresh ``unique_name`` guard), so
``state_dict`` keys read ``f"{param_key}_{accumulator}"`` as in the JAX
package. Parameter groups (a list of dicts with ``"params"``) are flattened
in order, as there. Per-parameter attributes are read with the JAX
package's defaults: ``need_clip`` (True), ``regularizer`` (None),
``optimize_attr`` (``{"learning_rate": 1.0}``).

dtypes follow JAX's promotion: the learning rate is an fp32 0-d array
there, so wherever it enters a rule the other operand is widened to fp32
and the result is rounded once to the parameter's dtype (torch would keep
a bf16 tensor times a 0-d fp32 tensor in bf16). Python constants meet a
bf16 or fp16 value as JAX's weakly typed scalars do: rounded to that type
first (``framework.dtype.weak_scalar``). Accumulators take the dtype the
rule gives them, so a bf16 parameter without master weights may carry fp32
moments (AdamW with decay: ``value * (1 - lr * coeff)`` is fp32).

``multi_precision``: a bf16/fp16 parameter gets an fp32 master copy; the
gradient is cast to fp32, the rule runs on the master (so its moments are
fp32 too), and the result is rounded once back into the parameter.
Parameters are written in place (``copy_``); each rule returns new
accumulator tensors, which replace the old ones, as JAX rebinds arrays.
"""
from __future__ import annotations

import torch

from ..framework.dtype import LOW_PRECISION, weak_scalar
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    """Base class: ``step``, ``clear_grad``, ``state_dict``.

    Args:
        learning_rate: a float or an :class:`~.lr.LRScheduler`.
        parameters: an iterable of ``torch.nn.Parameter`` (e.g.
            ``model.parameters()``), or a list of parameter groups.
        weight_decay: ``None``, a float (an L2 coefficient folded into the
            gradient; decoupled optimizers apply it themselves), or a
            :class:`~paddle_tpu_torch.regularizer.L2Decay` /
            :class:`~paddle_tpu_torch.regularizer.L1Decay`.
        grad_clip: ``None`` or a ``nn.clip`` instance.
        multi_precision: fp32 master weights for bf16/fp16 parameters.
    """

    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        if parameters is None:
            raise ValueError("the port's optimizers need parameters=")
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            parameters = [p for group in parameters for p in group["params"]]
        self._parameter_list = parameters
        self._keys = {id(p): f"param_{i}"
                      for i, p in enumerate(self._parameter_list)}
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators = {}
        self._pending_state = {}
        self._name = name or type(self).__name__
        self._step_count = 0
        # set by GradScaler's skipped step: accumulators born in it
        self._born = None

    # -- learning rate -------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- accumulators --------------------------------------------------------
    def _pkey(self, p):
        return self._keys[id(p)]

    _c = staticmethod(weak_scalar)

    def _add_accumulator(self, name, key, like, fill_value=0.0, shape=None):
        """The accumulator ``name`` of parameter ``key``, created at first
        use (from a pending ``set_state_dict`` entry if there is one) with
        ``like``'s dtype and device."""
        store = self._accumulators.setdefault(name, {})
        if key not in store:
            shape = like.shape if shape is None else shape
            pending = self._pending_state.pop(f"{key}_{name}", None)
            if pending is not None:
                store[key] = torch.as_tensor(pending).to(
                    device=like.device, dtype=like.dtype).reshape(shape).clone()
            else:
                store[key] = torch.full(shape, fill_value, dtype=like.dtype,
                                        device=like.device)
            if self._born is not None:
                self._born[name] = store[key]
        return store[key]

    def _set_accumulator(self, name, key, value):
        self._accumulators[name][key] = value

    def _uses_master(self, p):
        return self._multi_precision and p.dtype in LOW_PRECISION

    def _master_weight(self, p):
        """fp32 master copy of a low-precision parameter, made once from the
        parameter itself (or restored from ``set_state_dict``)."""
        store = self._accumulators.setdefault("master_weight", {})
        key = self._pkey(p)
        if key not in store:
            pending = self._pending_state.pop(f"{key}_master_weight", None)
            src = p.detach() if pending is None else torch.as_tensor(pending)
            store[key] = src.to(device=p.device,
                                dtype=torch.float32).reshape(p.shape).clone()
            if self._born is not None:
                self._born["master_weight"] = store[key]
        return store[key]

    # -- main API ------------------------------------------------------------
    def _apply_decay(self, p, g):
        """The optimizer's ``weight_decay`` folded into the gradient: L2Decay
        (or a float on a coupled optimizer) adds ``coeff * p``, L1Decay
        ``coeff * sign(p)``, on the parameter's own value."""
        wd = self._weight_decay
        pv = p.detach()
        if isinstance(wd, L2Decay):
            return g + self._c(wd.coeff, pv) * pv
        if isinstance(wd, L1Decay):
            return g + self._c(wd.coeff, pv) * torch.sign(pv)
        if isinstance(wd, float) and not self._decoupled_wd:
            return g + self._c(wd, pv) * pv
        return g

    def _params_grads(self):
        pgs = [(p, p.grad) for p in self._parameter_list if p.requires_grad]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        return pgs

    @torch.no_grad()
    def step(self):
        self._step(apply=True)

    def _step(self, apply):
        """One step. ``apply=False`` is the step GradScaler skips: the rule
        runs as in JAX (so the step count advances and accumulators are
        born with the dtypes the rule gives them), then every parameter
        keeps its value and every accumulator its pre-step value (a born
        one its fill, pending entry or, for a master weight, the
        parameter)."""
        self._step_count += 1
        lr = torch.tensor(self.get_lr(), dtype=torch.float32)
        for p, g in self._params_grads():
            if g is None:
                continue
            reg = getattr(p, "regularizer", None)
            if reg is not None:
                # the JAX package folds any per-parameter regularizer as
                # coeff * p (optimizer.py step)
                g = g + self._c(reg.coeff, p) * p.detach()
            else:
                g = self._apply_decay(p, g)
            param_lr = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            if apply:
                self._step_one(p, g, lr * param_lr)
            else:
                self._skip_one(p, g, lr * param_lr)

    def _step_one(self, p, g, lr):
        key = self._pkey(p)
        if self._uses_master(p):
            master = self._master_weight(p)
            new = self._update_param(key, master, g.float(), lr).float()
            self._set_accumulator("master_weight", key, new)
            p.copy_(new)
        else:
            p.copy_(self._update_param(key, p.detach(), g, lr))

    def _skip_one(self, p, g, lr):
        key = self._pkey(p)
        before = {name: store.get(key)
                  for name, store in self._accumulators.items()}
        self._born = {}
        try:
            if self._uses_master(p):
                master = self._master_weight(p)
                new = self._update_param(key, master, g.float(), lr).float()
                self._set_accumulator("master_weight", key, new)
            else:
                self._update_param(key, p.detach(), g, lr)
            for name, store in self._accumulators.items():
                if key not in store:
                    continue
                old = before.get(name)
                if old is None:
                    old = self._born[name]
                new = store[key]
                store[key] = old.to(torch.promote_types(old.dtype, new.dtype))
        finally:
            self._born = None

    def _update_param(self, key, value, grad, lr):
        """The new value of the parameter ``key`` (``value`` is its master
        copy under multi_precision, never written in place); sets the
        accumulators' new values."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient. ``set_to_zero`` is accepted for
        the JAX package's signature and, as there, changes nothing."""
        del set_to_zero
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    @staticmethod
    def _dygraph_only(loss):
        if not isinstance(loss, torch.Tensor):
            raise NotImplementedError(
                f"the port's optimizers take a dygraph loss tensor, got "
                f"{type(loss).__name__}: static Programs are ROADMAP.md A10")

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The JAX package's dygraph branch: ``loss.backward()``, then
        :meth:`step`; returns ``(None, None)``. The other arguments belong
        to its static branch and are ignored there too."""
        self._dygraph_only(loss)
        loss.backward()
        self.step()
        return None, None

    def backward(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None, callbacks=None):
        """``loss.backward()``; returns ``[(param, grad)]`` of the
        parameters that take gradients, for :meth:`apply_gradients`."""
        self._dygraph_only(loss)
        loss.backward()
        return [(p, p.grad) for p in self._parameter_list if p.requires_grad]

    @torch.no_grad()
    def apply_gradients(self, params_grads):
        """Each parameter's update rule on its given gradient, as the JAX
        package's ``apply_gradients``: no clip, regularizer, weight-decay
        folding, per-parameter learning rate or step count (those belong
        to :meth:`step`)."""
        lr = torch.tensor(self.get_lr(), dtype=torch.float32)
        for p, g in params_grads:
            if g is not None:
                self._step_one(p, g, lr)

    # -- state dict ----------------------------------------------------------
    def state_dict(self):
        """``{f"{param_key}_{accumulator}": tensor, "@step": int}`` (and
        ``"LR_Scheduler"`` with a scheduler), the tensors copied."""
        sd = {f"{key}_{name}": v.detach().clone()
              for name, store in self._accumulators.items()
              for key, v in store.items()}
        sd["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Restore accumulators (each keeps its device and dtype); entries
        for accumulators not made yet wait for their first use."""
        if "@step" in state_dict:
            self._step_count = int(state_dict["@step"])
        if ("LR_Scheduler" in state_dict
                and isinstance(self._learning_rate, LRScheduler)):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        applied = set()
        for name, store in self._accumulators.items():
            for key, v in store.items():
                k = f"{key}_{name}"
                if k in state_dict:
                    store[key] = torch.as_tensor(state_dict[k]).to(
                        device=v.device, dtype=v.dtype).reshape(v.shape).clone()
                    applied.add(k)
        self._pending_state = {k: v for k, v in state_dict.items()
                               if k not in ("@step", "LR_Scheduler")
                               and k not in applied}
