"""Autograd — port of ``paddle_tpu/autograd/engine.py`` on
``torch.autograd``.

The JAX package records its own tape (``GradNode``, ``Edge``) because a
``jax.vjp`` closure has no graph of its own; torch records one for every
op, so the port keeps no tape and ``GradNode``/``Edge`` are not ported.
``backward`` and ``grad`` keep Paddle's semantics: a non-scalar root is
seeded with ones, ``grad`` never touches ``.grad`` and honours
``retain_graph``, ``create_graph`` and ``allow_unused``. ``no_grad``,
``enable_grad`` and ``set_grad_enabled`` are context managers and
decorators over torch's grad mode.
"""
from __future__ import annotations

import functools

import torch

from ..framework.tensor import unwrap, wrap

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradGuard:
    """Context manager *and* decorator, like ``paddle.no_grad``."""

    def __init__(self, mode: bool):
        self._mode = bool(mode)

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn=None):
        if fn is None:
            return _GradGuard(self._mode)

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with _GradGuard(self._mode):
                return fn(*a, **k)

        return wrapper


def no_grad(fn=None):
    g = _GradGuard(False)
    return g(fn) if callable(fn) else g


def enable_grad(fn=None):
    g = _GradGuard(True)
    return g(fn) if callable(fn) else g


class set_grad_enabled(_GradGuard):
    """``set_grad_enabled(mode)``: sets the mode at once and, used as a
    context manager, restores the previous one on exit."""

    def __init__(self, mode: bool):
        super().__init__(mode)
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)

    def __enter__(self):
        return self


def _as_list(x):
    if x is None:
        return None
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _seeds(outputs, grad_outputs):
    """Plain roots and their cotangents: ones for a root given none (so a
    non-scalar root gets ones, as in the JAX package)."""
    grad_outputs = grad_outputs or [None] * len(outputs)
    roots, seeds = [], []
    for t, g in zip(outputs, grad_outputs):
        roots.append(unwrap(t))
        seeds.append(torch.ones_like(roots[-1]) if g is None and t.numel() != 1
                     else None if g is None
                     else unwrap(g) if isinstance(g, torch.Tensor)
                     else torch.as_tensor(g, dtype=t.dtype, device=t.device))
    return roots, seeds


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward`` / ``Tensor.backward``: accumulate into
    the leaves' ``.grad``. Roots that need no gradient are skipped."""
    tensors = _as_list(tensors)
    grad_tensors = _as_list(grad_tensors)
    pairs = [(t, g) for t, g in zip(
        tensors, grad_tensors or [None] * len(tensors)) if t.requires_grad]
    if not pairs:
        return
    roots, seeds = _seeds([t for t, _ in pairs], [g for _, g in pairs])
    torch.autograd.backward(roots, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """``paddle.grad``: gradients of ``outputs`` with respect to
    ``inputs``, without touching ``.grad``. ``retain_graph`` defaults to
    ``create_graph``; with ``create_graph=True`` the gradients carry their
    own graph (double backward). An input the outputs do not reach raises
    unless ``allow_unused``, which gives None for it."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    roots, seeds = _seeds(outputs, _as_list(grad_outputs))
    retain = create_graph if retain_graph is None else bool(retain_graph)
    try:
        got = torch.autograd.grad(roots, inputs, seeds, retain_graph=retain,
                                  create_graph=create_graph,
                                  allow_unused=allow_unused)
    except RuntimeError as e:
        if "appears to not have been used in the graph" in str(e):
            raise ValueError(
                "One of the differentiated tensors appears to not have been "
                "used in the graph; set allow_unused=True if this is "
                "intended.") from e
        raise
    return [None if g is None else wrap(g) for g in got]
