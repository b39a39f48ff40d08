"""The eager Tensor — port of ``paddle_tpu/framework/tensor.py``.

:class:`Tensor` is a subclass of ``torch.Tensor`` with torch's function
overriding turned off (``__torch_function__`` is
``torch._C._disabled_torch_function_impl``): a torch call on a Tensor runs
at torch's own cost and returns a plain ``torch.Tensor``. Paddle's methods
and operators are installed on the class by :mod:`paddle_tpu_torch.ops`, as
the JAX package patches its own Tensor, so the names that torch also uses
take Paddle's meaning on a Tensor: ``shape`` is a list, ``size`` an int,
``transpose(perm)``, ``reshape(shape)``, ``sum(axis, keepdim)``,
``max`` / ``min`` give values only, ``numpy()`` detaches and copies to the
host, ``stop_gradient`` is the inverse of ``requires_grad``.

Torch's own Python code must never receive a Tensor, because it calls
``.shape``, ``.size()`` or ``.transpose(a, b)`` with torch's meaning. Every
function of the port therefore hands torch a plain view (:func:`unwrap`:
``as_subclass(torch.Tensor)``, an alias that copies nothing and stays on the
autograd graph) and gives its result back as a Tensor (:func:`wrap`, which
re-types torch's fresh result object in place).

:class:`Parameter` subclasses ``torch.nn.Parameter``, not :class:`Tensor`:
torch's optimizers, ``nn.Module`` and ``load_state_dict`` read a
parameter's ``shape``, ``size()`` and ``grad`` with torch's meaning. It adds
only Paddle's names that torch does not use (``stop_gradient``,
``trainable``, ``name``, ``persistable``, ``set_value``, ``clear_grad``) and
a ``numpy()`` that detaches; ``isinstance(p, Tensor)`` is true all the same.
So ``weight.shape`` is a ``torch.Size`` where the JAX package gives a list
(``ROADMAP.md`` C).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtypes
from .place import Place, place_of, resolve_device

__all__ = ["Tensor", "Parameter", "to_tensor", "is_tensor", "wrap",
           "unwrap", "unwrap_args"]

_TB = torch._C.TensorBase
_PLAIN = torch.Tensor


class _TensorMeta(torch._C._TensorMeta):
    def __instancecheck__(cls, obj):
        # a Parameter is a paddle Tensor, though it keeps torch's names
        return (type.__instancecheck__(cls, obj)
                or (cls is Tensor and type.__instancecheck__(Parameter, obj)))


def unwrap(x):
    """A plain ``torch.Tensor`` alias of a tensor (a Tensor, a Parameter or
    a plain tensor); anything else unchanged."""
    if isinstance(x, _PLAIN):
        return x.as_subclass(_PLAIN)
    return x


def _unwrap_tree(x):
    if isinstance(x, _PLAIN):
        return x.as_subclass(_PLAIN)
    if type(x) in (list, tuple):
        return type(x)(_unwrap_tree(v) for v in x)
    if type(x) is dict:
        return {k: _unwrap_tree(v) for k, v in x.items()}
    return x


def unwrap_args(args, kwargs):
    return ([_unwrap_tree(a) for a in args],
            {k: _unwrap_tree(v) for k, v in kwargs.items()})


def wrap(x):
    """A torch result as a Tensor: a fresh plain tensor is re-typed in
    place (no copy, no graph node); lists, tuples and dicts are walked."""
    t = type(x)
    if t is _PLAIN:
        x.__class__ = Tensor
        return x
    if t is Tensor or x is None:
        return x
    if isinstance(x, _PLAIN):
        return x.as_subclass(Tensor)
    if t in (list, tuple):
        return t(wrap(v) for v in x)
    if t is dict:
        return {k: wrap(v) for k, v in x.items()}
    if isinstance(x, tuple):  # torch's named result tuples
        return tuple(wrap(v) for v in x)
    return x


def has_tensor(args, kwargs=None):
    """Whether a paddle :class:`Tensor` is among ``args`` (one level of
    lists and tuples) or ``kwargs``' values."""
    for a in args:
        t = type(a)
        if t is Tensor:
            return True
        if (t is list or t is tuple) and any(type(v) is Tensor for v in a):
            return True
    if kwargs:
        return any(type(v) is Tensor for v in kwargs.values())
    return False


def api(fn):
    """Decorate a port function that takes and returns plain tensors so
    that it also takes Paddle Tensors: when one is among its arguments, they
    reach ``fn`` as plain views and its result comes back as Tensors.
    Called with plain tensors only, it is ``fn`` (one scan of the
    arguments)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not has_tensor(args, kwargs):
            return fn(*args, **kwargs)
        args, kwargs = unwrap_args(args, kwargs)
        return wrap(fn(*args, **kwargs))

    return wrapper


def check_inplace(x):
    """Torch refuses an in-place change of a leaf that requires a gradient
    (the JAX package rebinds it on its tape); the port refuses it too, with
    Paddle's words. Under ``no_grad`` it is allowed."""
    if torch.is_grad_enabled() and x.requires_grad and x.is_leaf:
        raise RuntimeError(
            "in-place operation on a leaf Tensor with stop_gradient=False: "
            "the port follows torch here (the JAX package records it); run "
            "it under paddle.no_grad() or on a copy (ROADMAP.md C)")


class Tensor(torch.Tensor, metaclass=_TensorMeta):
    """``paddle.Tensor``: see the module docstring."""

    __torch_function__ = torch._C._disabled_torch_function_impl
    persistable = False

    @property
    def name(self):
        # torch's TensorBase has a read-only ``name``: Paddle's lives here
        return self.__dict__.get("_paddle_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value

    def __new__(cls, value=None, stop_gradient=True, name=None, place=None):
        t = to_tensor([] if value is None else value, place=place,
                      stop_gradient=stop_gradient)
        if name:
            t.name = name
        return t

    def __init__(self, *args, **kwargs):
        pass

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return list(_TB.shape.__get__(self))

    @property
    def size(self):
        return _TB.numel(self)

    def numel(self):
        return _TB.numel(self)

    @property
    def place(self) -> Place:
        return place_of(_TB.device.__get__(self))

    @property
    def grad(self):
        g = _TB.grad.__get__(self)
        return None if g is None else g.as_subclass(Tensor)

    @grad.setter
    def grad(self, g):
        _TB.grad.__set__(self, None if g is None else unwrap(g))

    @property
    def stop_gradient(self):
        return not _TB.requires_grad.__get__(self)

    @stop_gradient.setter
    def stop_gradient(self, value):
        if value:
            if not _TB.requires_grad.__get__(self):
                return
            if _TB.is_leaf.__get__(self):
                _TB.requires_grad_(self, False)
            elif _TB._is_view(self):
                raise RuntimeError(
                    "stop_gradient=True on a view of another tensor: torch "
                    "cannot detach a view in place; use .detach()")
            else:
                _TB.detach_(self)
        else:
            _TB.requires_grad_(self, True)

    @property
    def T(self):
        return self.transpose(list(range(self.ndim))[::-1])

    # -- conversion ---------------------------------------------------------
    def numpy(self):
        t = _TB.detach(self)
        if t.dtype == torch.bfloat16:
            # no ml_dtypes on the card's host: bf16 comes back as fp32
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(_TB.item(_TB.detach(self)))

    def __int__(self):
        return int(_TB.item(_TB.detach(self)))

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return _TB.shape.__get__(self)[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    __hash__ = torch.Tensor.__hash__

    def __repr__(self):
        plain = _TB.detach(self)
        body = repr(plain.float() if plain.dtype == torch.bfloat16
                    else plain).replace("\n", "\n       ")
        return (f"Tensor(shape={self.shape}, dtype="
                f"{dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n       {body})")

    __str__ = __repr__

    def __format__(self, spec):
        if self.ndim == 0:
            return self.item().__format__(spec)
        return object.__format__(self, spec)

    def __reduce_ex__(self, proto):
        return (_rebuild, (_TB.detach(self).as_subclass(_PLAIN),
                           self.stop_gradient))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = _rebuild(_TB.detach(self).as_subclass(_PLAIN).clone(),
                       self.stop_gradient)
        memo[id(self)] = out
        return out

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        from ..autograd import backward

        backward([self], None if grad_tensor is None else [grad_tensor],
                 retain_graph=retain_graph)

    def register_hook(self, hook):
        """``hook(grad)`` on this tensor's gradient; a Tensor it returns
        replaces the gradient."""
        def plain_hook(g):
            # an alias: the engine keeps using its own gradient object
            r = hook(g.as_subclass(Tensor))
            return None if r is None else unwrap(r)

        return _PLAIN.register_hook(self, plain_hook)

    def clear_grad(self, set_to_zero=False):
        g = _TB.grad.__get__(self)
        if set_to_zero and g is not None:
            g.zero_()
        else:
            _TB.grad.__set__(self, None)

    clear_gradient = clear_grad

    def detach(self):
        return wrap(_TB.detach(self))

    def detach_(self):
        _TB.detach_(self)
        return self

    def clone(self):
        return wrap(_TB.clone(self))

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return False

    # -- mutation -----------------------------------------------------------
    def set_value(self, value):
        """In-place overwrite (``Tensor.set_value``); the shape must match."""
        v = value if isinstance(value, _PLAIN) else torch.as_tensor(
            np.asarray(value))
        if tuple(v.shape) != tuple(_TB.shape.__get__(self)):
            raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} vs "
                             f"{tuple(_TB.shape.__get__(self))}")
        with torch.no_grad():
            _TB.copy_(self, unwrap(v))
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    # -- dtype / device -----------------------------------------------------
    def astype(self, dt):
        from .. import ops

        return ops.cast(self, dt)

    def cast(self, dt):
        return self.astype(dt)

    def cpu(self):
        return wrap(_TB.cpu(self))

    def cuda(self, device_id=None, blocking=True):
        return wrap(_TB.to(self, resolve_device(
            "cuda" if device_id is None else f"cuda:{device_id}")))

    def to(self, *args, **kwargs):
        """``Tensor.to(dtype)`` / ``to(device[, dtype])``; an argument that
        is neither raises."""
        kwargs.pop("blocking", None)
        dev, dt = None, None
        for a in list(args) + list(kwargs.values()):
            if a is None or isinstance(a, bool):
                continue
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and a.split(":", 1)[0] in (
                        "cpu", "gpu", "cuda", "gpu_pinned")):
                dev = resolve_device("cpu" if a == "gpu_pinned" else a)
                continue
            try:
                dt = dtypes.convert_dtype(a)
            except (ValueError, TypeError):
                raise ValueError(
                    f"Tensor.to(): unrecognized argument {a!r} (expected a "
                    "dtype, a place string like 'cpu'/'gpu:0', or a Place)"
                ) from None
        return wrap(_TB.to(self, device=dev, dtype=dt))

    def pin_memory(self):
        return self

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        from ..ops import manipulation

        return manipulation._getitem(self, idx)

    def __setitem__(self, idx, value):
        from ..ops import manipulation

        manipulation._setitem_(self, idx, value)


def _rebuild(plain, stop_gradient):
    t = torch.Tensor._make_subclass(Tensor, plain, not stop_gradient)
    return t


class Parameter(torch.nn.Parameter):
    """A trainable tensor (``paddle.framework.Parameter``): a
    ``torch.nn.Parameter`` with Paddle's attributes. See the module
    docstring for why it keeps torch's ``shape``."""

    _counter = 0

    @property
    def name(self):
        # torch's TensorBase has a read-only ``name``: Paddle's lives here
        return self.__dict__.get("_paddle_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value

    def __new__(cls, data=None, requires_grad=True, name=None,
                trainable=None):
        if data is None:
            data = torch.empty(0)
        if trainable is not None:
            requires_grad = bool(trainable)
        return torch.Tensor._make_subclass(cls, unwrap(data).detach(),
                                           requires_grad)

    def __init__(self, data=None, requires_grad=True, name=None,
                 trainable=None):
        _init_param_attrs(self, name)

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def set_value(self, value):
        v = value if isinstance(value, _PLAIN) else torch.as_tensor(
            np.asarray(value))
        if tuple(v.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} vs "
                             f"{tuple(self.shape)}")
        with torch.no_grad():
            self.copy_(unwrap(v))
        return self

    def clear_grad(self, set_to_zero=False):
        if set_to_zero and self.grad is not None:
            self.grad.zero_()
        else:
            self.grad = None

    clear_gradient = clear_grad

    def numpy(self):
        t = self.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __repr__(self):
        return "Parameter containing:\n" + repr(self.as_subclass(Tensor))


def _init_param_attrs(p, name=None):
    """Paddle's attributes on a parameter (also used to re-type a
    ``torch.nn.Parameter`` in place)."""
    if not name:
        name = f"param_{Parameter._counter}"
        Parameter._counter += 1
    p.name = name
    p.persistable = True
    p.optimize_attr = {"learning_rate": 1.0}
    p.regularizer = None
    p.do_model_average = None
    p.need_clip = True
    p.is_distributed = False


def as_parameter(p):
    """Re-type a ``torch.nn.Parameter`` as a :class:`Parameter` in place
    (the same object, so shared and tied weights stay one)."""
    if type(p) is torch.nn.Parameter:
        p.__class__ = Parameter
        _init_param_attrs(p)
    return p


def _default_float(a):
    return a.astype(dtypes.to_numpy_dtype(dtypes.get_default_dtype()))


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor`` on the current place (or ``place``). Python
    floats take the default dtype, Python ints int64; a numpy array keeps
    its dtype (float64 and int64 included, where the JAX package's x64-off
    arrays give float32 and int32)."""
    dt = dtypes.convert_dtype(dtype)
    dev = resolve_device(place)
    if isinstance(data, _PLAIN):
        t = _TB.detach(data).to(device=dev, dtype=dt)
        if t is data or (t.data_ptr() == data.data_ptr() and t.numel()):
            t = t.clone()
    else:
        if isinstance(data, (list, tuple)) and any(
                isinstance(v, _PLAIN) for v in data):
            data = [np.asarray(unwrap(v).detach().float().cpu())
                    if isinstance(v, _PLAIN) and v.dtype == torch.bfloat16
                    else np.asarray(unwrap(v).detach().cpu())
                    if isinstance(v, _PLAIN) else v for v in data]
        a = np.asarray(data)
        if dt is None and a.dtype == np.float64 and not isinstance(
                data, np.ndarray) and not isinstance(data, np.generic):
            a = _default_float(a)
        if a.dtype.kind == "U" or a.dtype == object:
            raise TypeError(f"to_tensor: cannot make a tensor of {a.dtype}")
        # a copy (np.array copies): the tensor never shares the caller's
        # array
        t = torch.from_numpy(np.array(a)).to(device=dev)
        if dt is not None:
            t = t.to(dt)
    t = torch.Tensor._make_subclass(Tensor, t, not stop_gradient)
    return t


def is_tensor(x):
    return isinstance(x, Tensor)
