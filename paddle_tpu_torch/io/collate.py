"""Batch collation — port of ``paddle_tpu/io/collate.py`` (reference
``python/paddle/fluid/dataloader/collate.py``).

Collation is split in two. :func:`collate_numpy` stacks samples into numpy
arrays (numbers to arrays, dicts and sequences recursed, strings kept as
lists) and touches no device, so a worker process may run it. :func:`to_place`
turns the numpy leaves of a collated batch into Tensors on a place; the
``DataLoader`` runs it in the parent. :func:`default_collate_fn` is the two
in a row, on the current place, as the JAX package's collates to device
Tensors.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..framework.place import resolve_device
from ..framework.tensor import unwrap, wrap

__all__ = ["default_collate_fn", "default_convert_fn", "collate_numpy",
           "to_place"]


def _host_array(t):
    t = unwrap(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def collate_numpy(batch):
    """Stack a list of samples into numpy arrays (the JAX package's
    ``default_collate_fn`` without the device Tensor)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if isinstance(sample, torch.Tensor):
        return np.stack([_host_array(s) for s in batch], axis=0)
    if isinstance(sample, numbers.Number):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: collate_numpy([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return [collate_numpy(list(fields)) for fields in zip(*batch)]
    raise TypeError(f"cannot collate batch of {type(sample)}")


def to_place(batch, device):
    """The numpy leaves of ``batch`` as Tensors on ``device`` (a
    ``torch.device``); lists, tuples and dicts are walked, other leaves kept.
    A host array is not copied on the CPU."""
    if isinstance(batch, (np.ndarray, np.generic)):
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if t.device != device:
            t = t.to(device)
        return wrap(t)
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_place(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: to_place(v, device) for k, v in batch.items()}
    return batch


def default_collate_fn(batch):
    """Collate ``batch`` into Tensors on the current place."""
    return to_place(collate_numpy(batch), resolve_device(None))


def default_convert_fn(batch):
    """Arrays and Tensors as Tensors on the current place; sequences
    recursed."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        if isinstance(batch, torch.Tensor):
            return wrap(unwrap(batch).to(resolve_device(None)))
        return to_place(batch, resolve_device(None))
    if isinstance(batch, (list, tuple)):
        return [default_convert_fn(b) for b in batch]
    return batch

