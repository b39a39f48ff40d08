"""Carry weights and optimizer state over from the JAX package's models.

``load_jax_state(model, state)`` fills a port model from the JAX model's
``state_dict()`` given as ``{name: numpy array}`` (the names match: the port
mirrors the JAX module tree): its parameters and its persistable buffers
(the batch norms' ``_mean`` and ``_variance``), for any port model or
layer whose tree mirrors the JAX one (GPT, the encoders, ResNet, the
MobileNets, ``PReLU``'s slopes, ``Bilinear``, ``Embedding``). It is
``Layer.set_state_dict``
(:func:`~paddle_tpu_torch.nn.layer.layers.copy_state`) held strict: a
missing or unexpected name raises. Both packages keep Paddle's layouts
(``Linear.weight`` ``[in, out]``, convolution weights ``[out, in/groups,
*k]``), so nothing is transposed.
A parameter shared by two modules (ERNIE's MLM head reuses the word
embedding) is one entry, under the name ``named_parameters()`` gives it
first, as the JAX model's ``state_dict`` lists it.

``load_jax_optimizer_state(opt, state, model, jax_names)`` does the same for
an optimizer's ``state_dict()`` (the accumulators of every ported optimizer,
fp32 master weights, ``@step`` and ``LR_Scheduler``), so a JAX training run
can be resumed by the port. A JAX ``GradScaler.state_dict()`` loads as it
is (``amp.GradScaler.load_state_dict``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layer.layers import copy_state

__all__ = ["load_jax_state", "load_jax_optimizer_state"]


def load_jax_state(model, state):
    """Copy ``state`` (``{name: np.ndarray}``) into ``model``'s parameters
    and persistable buffers, in place, keeping each one's device, dtype and
    memory format. Raises on a missing or unexpected name or a shape that
    does not match."""
    copy_state(model, state, strict=True)
    return model


#: accumulator names of the ported optimizers
_ACCUMULATORS = ("avg_squared_update", "avg_squared_grad", "master_weight",
                 "mean_square", "mean_grad", "beta1_pow", "beta2_pow",
                 "inf_norm", "velocity", "momentum", "moment1", "moment2",
                 "moment")


def load_jax_optimizer_state(opt, state, model, jax_names):
    """Restore ``opt`` (a port optimizer over ``model``'s parameters) from
    the JAX optimizer's ``state_dict()`` given as ``{key: numpy array}``.

    The JAX package keys an accumulator by its parameter's own name
    (``f"{param.name}_{accumulator}"``, e.g. ``param_3_moment1``);
    ``jax_names`` maps each of ``model``'s parameter names (the module
    path, shared by both packages) to that JAX name:
    ``{n: p.name for n, p in jax_model.named_parameters()}``. Raises on a
    JAX entry it cannot place."""
    port_key = {name: opt._pkey(p) for name, p in model.named_parameters()}
    by_jax = {jax_names[name]: name for name in port_key}
    out = {}
    for k, v in state.items():
        if k == "@step":
            out[k] = int(np.asarray(v))
            continue
        if k == "LR_Scheduler":
            out[k] = dict(v)
            continue
        acc = next((a for a in _ACCUMULATORS if k.endswith("_" + a)), None)
        name = None if acc is None else by_jax.get(k[:-len(acc) - 1])
        if name is None:
            raise KeyError(f"optimizer state entry {k!r} names no accumulator "
                           f"of a parameter of the model")
        out[f"{port_key[name]}_{acc}"] = torch.from_numpy(np.array(
            np.asarray(v)))
    opt.set_state_dict(out)
    return opt
