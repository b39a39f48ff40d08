"""Optimizer base — port of ``paddle_tpu.optimizer.optimizer``.

Each optimizer's update rule is plain tensor code over (value, grad,
accumulators), run once a parameter per :meth:`Optimizer.step`. Accumulators
live in ``self._accumulators[name][param_key]`` and are created at first use,
in the dtype of the value being updated. Parameters are keyed by name:
``param_<i>`` in the order given (what the JAX package's names are when a
model is built under a fresh ``unique_name`` guard), so ``state_dict`` keys
read ``f"{param_key}_{accumulator}"`` as in the JAX package.

``multi_precision``: a bf16/fp16 parameter gets an fp32 master copy; the
gradient is cast to fp32, the rule runs on the master (so its moments are
fp32 too), and the result is rounded once back into the parameter. The port
writes parameters and accumulators in place (``copy_``), where the JAX
package rebinds new arrays.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    """Base class: ``step``, ``clear_grad``, ``state_dict``.

    Args:
        learning_rate: a float.
        parameters: an iterable of ``torch.nn.Parameter`` (e.g.
            ``model.parameters()``).
        weight_decay: ``None`` or a float: an L2 coefficient folded into
            the gradient (decoupled optimizers apply it themselves).
        multi_precision: fp32 master weights for bf16/fp16 parameters.
    """

    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 name=None, multi_precision=False):
        if parameters is None:
            raise ValueError("the port's optimizers need parameters=")
        self._parameter_list = list(parameters)
        self._keys = {id(p): f"param_{i}"
                      for i, p in enumerate(self._parameter_list)}
        self._learning_rate = float(learning_rate)
        if weight_decay is not None and not isinstance(weight_decay, float):
            raise TypeError("weight_decay must be None or a float")
        self._weight_decay = weight_decay
        self._multi_precision = bool(multi_precision)
        self._accumulators = {}
        self._pending_state = {}
        self._name = name or type(self).__name__
        self._step_count = 0

    # -- learning rate -------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- accumulators --------------------------------------------------------
    def _pkey(self, p):
        return self._keys[id(p)]

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
        return store[key]

    def _uses_master(self, p):
        return self._multi_precision and p.dtype in _LOW_PRECISION

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
        return store[key]

    # -- main API ------------------------------------------------------------
    def _apply_decay(self, p, g):
        """L2 decay folded into the gradient (a float ``weight_decay`` on a
        coupled optimizer), on the parameter's own value."""
        wd = self._weight_decay
        if wd is None or self._decoupled_wd:
            return g
        return g + wd * p.detach()

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        # the JAX package runs the rule on an fp32 0-d learning rate
        lr = torch.tensor(self._learning_rate, dtype=torch.float32)
        for p in self._parameter_list:
            if not p.requires_grad or p.grad is None:
                continue
            g = self._apply_decay(p, p.grad)
            key = self._pkey(p)
            if self._uses_master(p):
                master = self._master_weight(p)
                master.copy_(self._update_param(key, master, g.float(), lr))
                p.copy_(master.to(p.dtype))
            else:
                p.copy_(self._update_param(key, p.detach(), g, lr))

    def _update_param(self, key, value, grad, lr):
        """The new value of the parameter ``key`` (``value`` is its master
        copy under multi_precision); updates the accumulators."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient. ``set_to_zero`` is accepted for
        the JAX package's signature and, as there, changes nothing."""
        del set_to_zero
        for p in self._parameter_list:
            p.grad = None

    # -- state dict ----------------------------------------------------------
    def state_dict(self):
        """``{f"{param_key}_{accumulator}": tensor, "@step": int}``, the
        tensors copied (the optimizer updates its own in place)."""
        sd = {f"{key}_{name}": v.detach().clone()
              for name, store in self._accumulators.items()
              for key, v in store.items()}
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        """Restore accumulators in place; entries for accumulators not made
        yet wait for their first use."""
        if "@step" in state_dict:
            self._step_count = int(state_dict["@step"])
        applied = set()
        for name, store in self._accumulators.items():
            for key, v in store.items():
                k = f"{key}_{name}"
                if k in state_dict:
                    v.copy_(torch.as_tensor(state_dict[k]).reshape(v.shape))
                    applied.add(k)
        self._pending_state = {k: v for k, v in state_dict.items()
                               if k != "@step" and k not in applied}
