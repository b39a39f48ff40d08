"""Carry weights and optimizer state over from the JAX package's models.

``load_jax_state(model, state)`` fills a port model from the JAX model's
``state_dict()`` given as ``{name: numpy array}`` (the names match: the port
mirrors the JAX module tree). paddle's ``Linear.weight`` is ``[in, out]``
(``paddle_tpu/nn/layer/common.py``) while ``torch.nn.Linear.weight`` is
``[out, in]``, so every Linear weight is transposed on the way in.

``load_jax_optimizer_state(opt, state, model, jax_names)`` does the same for
an optimizer's ``state_dict()`` (moments, beta powers, fp32 master weights
and ``@step``), so a JAX training run can be resumed by the port.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_state", "load_jax_optimizer_state"]


def _linear_weights(model):
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def load_jax_state(model, state):
    """Copy ``state`` (``{name: np.ndarray}``) into ``model``'s parameters,
    in place, keeping each parameter's device and dtype. Raises on a missing
    or unexpected name or a shape that does not match."""
    linear_weights = _linear_weights(model)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(state[name])
            if name in linear_weights:
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: state has shape {arr.shape}, the "
                                 f"model {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))  # a writable copy
    return model


#: accumulator names of the ported optimizers
_ACCUMULATORS = ("moment1", "moment2", "beta1_pow", "beta2_pow",
                 "master_weight")


def load_jax_optimizer_state(opt, state, model, jax_names):
    """Restore ``opt`` (a port optimizer over ``model``'s parameters) from
    the JAX optimizer's ``state_dict()`` given as ``{key: numpy array}``.

    The JAX package keys an accumulator by its parameter's own name
    (``f"{param.name}_{accumulator}"``, e.g. ``param_3_moment1``);
    ``jax_names`` maps each of ``model``'s parameter names (the module
    path, shared by both packages) to that JAX name:
    ``{n: p.name for n, p in jax_model.named_parameters()}``. Accumulators
    of a Linear weight (moments, master weight) are transposed as the
    weight is. Raises on a JAX entry it cannot place."""
    linear_weights = _linear_weights(model)
    port_key = {name: opt._pkey(p) for name, p in model.named_parameters()}
    by_jax = {jax_names[name]: name for name in port_key}
    out = {}
    for k, v in state.items():
        if k == "@step":
            out[k] = int(np.asarray(v))
            continue
        acc = next((a for a in _ACCUMULATORS if k.endswith("_" + a)), None)
        name = None if acc is None else by_jax.get(k[:-len(acc) - 1])
        if name is None:
            raise KeyError(f"optimizer state entry {k!r} names no accumulator "
                           f"of a parameter of the model")
        arr = np.asarray(v)
        if name in linear_weights and arr.ndim == 2:
            arr = arr.T
        out[f"{port_key[name]}_{acc}"] = torch.from_numpy(np.array(arr))
    opt.set_state_dict(out)
    return opt
