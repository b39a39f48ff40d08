"""``paddle.save`` / ``paddle.load`` — port of
``paddle_tpu/framework/io.py``, in the JAX package's format: a pickle in
which every tensor is a bare numpy array, so a ``.pdparams`` file written
by either package loads in the other.

The card's host has no ``ml_dtypes``, so numpy has no bfloat16 there: a
bf16 tensor is saved as an fp32 array (exact), and ``set_state_dict`` casts
it back to the parameter's dtype. ``save`` is atomic (a same-directory
temporary file, fsynced and renamed over the destination); ``load`` raises
:class:`CheckpointCorruptError` for a truncated or garbage file. ``load``
gives Tensors on the current place (``return_numpy=True``: the arrays).
"""
from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

from .tensor import to_tensor

__all__ = ["save", "load", "CheckpointCorruptError", "atomic_write"]

_PROTO = 4


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is truncated, garbage, or fails its checksum;
    ``path`` names it and ``__cause__`` holds the decode error."""

    def __init__(self, path, reason=""):
        self.path = str(path)
        msg = f"corrupt checkpoint file {self.path!r}"
        if reason:
            msg += f": {reason}"
        super().__init__(msg)


def atomic_write(path, write_fn, fsync_parent=True):
    """Write ``path`` atomically: ``write_fn(file)`` into a same-directory
    temp file, flush + fsync, then ``os.replace`` over the destination;
    ``fsync_parent`` also fsyncs the directory so the rename is durable."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync_parent:
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass


def _array(t):
    t = t.detach().as_subclass(torch.Tensor)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        return _array(obj)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else to_tensor(obj)
    if isinstance(obj, dict):
        if obj.get("__tensor__"):  # the JAX package's legacy wrapper
            if return_numpy:
                return obj["value"]
            t = to_tensor(obj["value"])
            t.name = obj.get("name", "")
            return t
        return {k: _from_serializable(v, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=_PROTO, **configs):
    data = _to_serializable(obj)
    atomic_write(path, lambda f: pickle.dump(data, f, protocol=protocol))


def load(path, return_numpy=False, **configs):
    try:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    except (pickle.UnpicklingError, EOFError, ValueError, AttributeError,
            ImportError, IndexError, MemoryError) as e:
        raise CheckpointCorruptError(path, f"{type(e).__name__}: {e}") from e
    return _from_serializable(obj, return_numpy=return_numpy)
