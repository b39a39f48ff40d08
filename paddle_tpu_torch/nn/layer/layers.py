"""Layer — port of ``paddle_tpu/nn/layer/layers.py``.

:class:`Layer` is a ``torch.nn.Module`` with Paddle's surface:
``parameters()`` is a list, ``named_sublayers``, ``sublayers``,
``add_sublayer``, ``create_parameter`` (with :class:`ParamAttr`),
``register_buffer(..., persistable=)``, the forward pre/post hooks,
``state_dict`` (parameters then persistable buffers, the live tensors, as
the JAX package gives them) and ``set_state_dict`` (copies values in place,
returns the missing and unexpected keys), ``clear_gradients`` and ``to``.
Every ``torch.nn.Parameter`` assigned to a Layer (or held by a torch module
assigned to it) is re-typed in place as the port's
:class:`~paddle_tpu_torch.framework.tensor.Parameter`, so tied weights stay
one object.

A call with Paddle Tensors among its arguments hands ``forward`` plain
views and gives back Tensors; a call with plain tensors (every Layer inside
a model) runs ``forward`` as it is, so the layers inside pay nothing, and
gives back a plain tensor (a Tensor that a registry op made is re-viewed
plain).

A Layer built outside any other Layer's constructor lands on its
``device`` keyword, or without one on the current place (``set_device``):
the place is resolved before the constructor runs (a card that is not
there raises at once), and what the constructor built elsewhere (weights
drawn on the CPU) is moved there once it returns. This is the one place
that decides where a layer lives: the layers and models inside build on
the CPU and move with the outermost.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ...framework import dtype as dtypes
from ...framework.place import resolve_device
from ...framework.tensor import (Parameter, Tensor, as_parameter,
                                 has_tensor, unwrap, unwrap_args, wrap)
from ..initializer import apply_initializer

__all__ = ["Layer", "ParamAttr", "make_parameter", "copy_state",
           "state_items"]


class ParamAttr:
    """``paddle.ParamAttr``: a parameter's name, initializer, learning rate
    multiplier, regularizer, trainable and need_clip."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr(initializer=attr)  # an Initializer


def make_parameter(shape, attr, dtype, is_bias=False,
                   default_initializer=None, device=None, generator=None):
    """A :class:`Parameter` drawn on the CPU by ``attr``'s initializer (or
    ``default_initializer``; None: zeros for a bias, XavierNormal for a
    weight), on ``device`` (None: stays on the CPU), with ``attr``'s
    name, trainable, learning rate, regularizer and need_clip."""
    init = attr.initializer or default_initializer
    value = apply_initializer(init, shape, dtype, is_bias=is_bias,
                              generator=generator)
    if device is not None:
        value = value.to(device)
    p = Parameter(value, requires_grad=attr.trainable, name=attr.name)
    p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


class HookRemoveHelper:
    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        self._handle.remove()


_layer_name_counters = {}
_building = threading.local()


def _unique_layer_name(prefix):
    n = _layer_name_counters.get(prefix, 0)
    _layer_name_counters[prefix] = n + 1
    return f"{prefix}_{n}"


def _retype_params(module):
    """Re-type the parameters of a torch module that is not a Layer (a
    Layer's own are re-typed as they are registered)."""
    if not isinstance(module, Layer):
        for p in module.parameters():
            as_parameter(p)


class _LayerMeta(type):
    """Places a Layer built outside another Layer's constructor on its
    ``device`` keyword (None: the current place)."""

    def __call__(cls, *args, **kwargs):
        depth = getattr(_building, "depth", 0)
        dev = resolve_device(kwargs.get("device")) if depth == 0 else None
        _building.depth = depth + 1
        try:
            obj = super().__call__(*args, **kwargs)
        finally:
            _building.depth = depth
        if dev is not None and any(t.device != dev
                                   for t in obj._all_tensors()):
            nn.Module.to(obj, device=dev)
        return obj


class Layer(nn.Module, metaclass=_LayerMeta):
    """``paddle.nn.Layer`` on ``torch.nn.Module``; see the module
    docstring."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._full_name = _unique_layer_name(
            name_scope or type(self).__name__.lower())
        self._dtype = dtypes.convert_dtype(dtype)

    def __call__(self, *args, **kwargs):
        if not has_tensor(args, kwargs):
            out = nn.Module.__call__(self, *args, **kwargs)
            # plain in, plain out, though forward ran a registry op
            return unwrap(out) if type(out) is Tensor else out
        args, kwargs = unwrap_args(args, kwargs)
        return wrap(nn.Module.__call__(self, *args, **kwargs))

    def _all_tensors(self):
        yield from (p for p in self.parameters() if p is not None)
        yield from (b for b in self.buffers() if b is not None)

    # -- construction helpers ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtypes.convert_dtype(dtype) or self._dtype
        return make_parameter(shape, attr, dtype, is_bias,
                              default_initializer)

    def create_variable(self, name=None, persistable=None, dtype=None):
        t = wrap(torch.zeros([], dtype=dtypes.convert_dtype(dtype)
                             or self._dtype))
        t.persistable = bool(persistable)
        return t

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def register_parameter(self, name, param):
        if param is not None:
            as_parameter(param)
        super().register_parameter(name, param)

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def add_module(self, name, module):
        if module is not None:
            _retype_params(module)
        super().add_module(name, module)

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        if persistent is not None:
            persistable = persistent
        if tensor is not None and type(tensor) is not torch.Tensor:
            tensor = tensor.as_subclass(torch.Tensor)
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def __setattr__(self, name, value):
        if isinstance(value, nn.Module) and not isinstance(value, Layer):
            _retype_params(value)
        super().__setattr__(name, value)

    # -- traversal -----------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return list(super().parameters(recurse=include_sublayers))

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix=prefix,
                                        recurse=include_sublayers,
                                        remove_duplicate=remove_duplicate)

    def named_sublayers(self, prefix="", include_self=False):
        for name, sub in self.named_modules(prefix=prefix):
            if sub is self and not include_self:
                continue
            yield name, sub

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def buffers(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return list(super().buffers(recurse=include_sublayers))

    def full_name(self):
        return self._full_name

    # -- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        return HookRemoveHelper(super().register_forward_pre_hook(hook))

    def register_forward_post_hook(self, hook):
        return HookRemoveHelper(super().register_forward_hook(hook))

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True, *args, **kwargs):
        """Parameters, then persistable buffers, by structured name: the
        live tensors (Paddle's), not detached copies (torch's). Called with
        torch's ``prefix``/``keep_vars`` (by a torch module that holds this
        Layer) it is torch's ``state_dict``."""
        if args or kwargs:
            return super().state_dict(*args, destination=destination,
                                      **kwargs)
        dest = OrderedDict() if destination is None else destination
        dest.update(state_items(self, include_sublayers))
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (Tensors, torch tensors or numpy
        arrays) into the parameters and buffers in place, keeping each
        one's dtype and device; returns ``(missing, unexpected)``."""
        return copy_state(self, state_dict, strict=False)

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype / device ------------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device=None, dtype=None)`` (a place, ``'gpu'``, ``'cpu'``
        or a torch device; a dtype name or torch dtype); torch's positional
        forms are taken too. Only floating tensors change dtype."""
        for a in args:
            if isinstance(a, torch.dtype) or (
                    isinstance(a, str) and a in dtypes._NAME_TO_DTYPE):
                dtype = a
            else:
                device = a
        kw = {}
        if device is not None:
            kw["device"] = resolve_device(device)
        if dtype is not None:
            kw["dtype"] = dtypes.convert_dtype(dtype)
        nn.Module.to(self, **kw, **kwargs)
        if dtype is not None:
            for sub in self.modules():
                if isinstance(sub, Layer):
                    sub._dtype = kw["dtype"]
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_grad(set_to_zero)

    def extra_repr(self):
        return ""


def _persistent_buffers(module, include_sublayers=True):
    """The buffers a state_dict saves, by module path (no duplicates)."""
    out, seen = OrderedDict(), set()
    mods = module.named_modules() if include_sublayers else [("", module)]
    for prefix, mod in mods:
        for name, buf in mod._buffers.items():
            if (buf is None or name in mod._non_persistent_buffers_set
                    or id(buf) in seen):
                continue
            seen.add(id(buf))
            out[f"{prefix}.{name}" if prefix else name] = buf
    return out


def state_items(module, include_sublayers=True):
    """``module``'s parameters (as ``named_parameters`` gives them, a
    shared one once) then its persistable buffers, by name."""
    items = OrderedDict(nn.Module.named_parameters(
        module, recurse=include_sublayers))
    items.update(_persistent_buffers(module, include_sublayers))
    return items


def _as_plain_array(v):
    if isinstance(v, torch.Tensor):
        return v.detach().as_subclass(torch.Tensor)
    return torch.from_numpy(np.array(v))  # a writable copy


def copy_state(module, state, strict=True):
    """Copy ``state`` (name -> Tensor, torch tensor or numpy array) into
    ``module``'s parameters and persistable buffers in place, keeping each
    one's device, dtype and memory format. A shape that does not match
    raises; missing or unexpected names raise when ``strict``, else come
    back as ``(missing, unexpected)``."""
    own = state_items(module)
    missing = [k for k in own if k not in state]
    unexpected = [k for k in state if k not in own]
    if strict and (missing or unexpected):
        raise KeyError(f"state does not match the model: missing "
                       f"{sorted(missing)}, unexpected {sorted(unexpected)}")
    with torch.no_grad():
        for name, tgt in own.items():
            if name not in state:
                continue
            val = _as_plain_array(state[name])
            if tuple(val.shape) != tuple(tgt.shape):
                raise ValueError(f"{name}: state has shape "
                                 f"{tuple(val.shape)}, the model "
                                 f"{tuple(tgt.shape)}")
            tgt.as_subclass(torch.Tensor).copy_(val)
    return missing, unexpected
