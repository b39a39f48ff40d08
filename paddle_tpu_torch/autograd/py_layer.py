"""PyLayer — port of ``paddle_tpu/autograd/py_layer.py`` over
``torch.autograd.Function``.

Each PyLayer subclass gets one ``torch.autograd.Function`` whose forward
calls the user's ``forward(ctx, *args, **kwargs)`` (under no_grad, as in the
JAX package) and whose backward calls the user's ``backward(ctx, *grads)``;
torch records it on its own graph, so with ``create_graph=True`` the user's
backward is itself recorded and double backward composes through it.
``backward`` returns one gradient per *Tensor* input of ``forward`` (None
allowed); the port gives torch None for every other argument.
"""
from __future__ import annotations

import torch

from ..framework.tensor import Tensor, unwrap, wrap

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """Carries state from forward to backward: ``save_for_backward`` /
    ``saved_tensor``, ``mark_non_differentiable``,
    ``set_materialize_grads`` and any attribute the user sets."""

    def __init__(self, tctx=None):
        self._tctx = tctx
        self.not_inplace = False
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._tctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return [t.as_subclass(Tensor) for t in self._tctx.saved_tensors]

    def mark_not_inplace(self, *args):
        self.not_inplace = True

    def mark_non_differentiable(self, *tensors):
        self._tctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)
        self._tctx.set_materialize_grads(bool(value))


def _function_of(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(tctx, spec, *flat):
            n_args, keys = spec
            ctx = PyLayerContext(tctx)
            tctx.paddle_ctx = ctx
            tctx.n_flat = len(flat)
            tctx.tensor_pos = [i for i, a in enumerate(flat)
                               if isinstance(a, torch.Tensor)]
            vals = [wrap(a) for a in flat]
            out = cls.forward(ctx, *vals[:n_args],
                              **dict(zip(keys, vals[n_args:])))
            return out

        @staticmethod
        def backward(tctx, *grads):
            ctx = tctx.paddle_ctx
            got = cls.backward(ctx, *[None if g is None
                                      else g.as_subclass(Tensor)
                                      for g in grads])
            if not isinstance(got, (tuple, list)):
                got = (got,)
            pos = tctx.tensor_pos
            if len(got) < len(pos):
                raise ValueError(
                    f"{cls.__name__}.backward returned {len(got)} gradients "
                    f"but the forward had {len(pos)} Tensor inputs.")
            full = [None] * (1 + tctx.n_flat)
            for i, g in zip(pos, got):
                full[1 + i] = None if g is None else unwrap(g)
            return tuple(full)

    _Fn.__name__ = _Fn.__qualname__ = f"{cls.__name__}Function"
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    """``paddle.autograd.PyLayer``: subclass with static ``forward(ctx,
    *args)`` and ``backward(ctx, *grads)`` and call ``apply``::

        class Scale(PyLayer):
            @staticmethod
            def forward(ctx, x, alpha):
                ctx.save_for_backward(x)
                ctx.alpha = alpha
                return x * alpha

            @staticmethod
            def backward(ctx, dy):
                return dy * ctx.alpha

        y = Scale.apply(x, 2.0)
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError(
            "You must implement the forward function for PyLayer.")

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError(
            "You must implement the backward function for PyLayer.")

    @classmethod
    def apply(cls, *args, **kwargs):
        fn = _function_of(cls)
        flat = [unwrap(a) for a in list(args) + list(kwargs.values())]
        spec = (len(args), tuple(kwargs))
        return wrap(fn.apply(spec, *flat))
