"""Search and sort — port of ``paddle_tpu/ops/search.py``. Sorts are
stable, so ties come out in the order the JAX package gives them."""
from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework.tensor import wrap
from .dispatch import op, plain


def _arg(fn, x, axis, keepdim, dtype):
    v = plain(x)
    if axis is None:
        v = v.reshape(-1)
        axis = 0
    return wrap(fn(v, dim=axis, keepdim=keepdim).to(
        dtypes.convert_dtype(dtype)))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return wrap(torch.argsort(plain(x), dim=axis, descending=descending,
                              stable=True))


@op("sort")
def _sort_raw(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return _sort_raw(x, axis=axis, descending=descending)


@op("topk_op")
def _topk_raw(x, k=1, axis=-1, largest=True):
    v, i = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return v, i


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    if isinstance(k, torch.Tensor):
        k = int(plain(k).item())
    return _topk_raw(x, k=int(k), axis=int(axis), largest=largest)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    v, i = _topk_raw(x, k=int(k), axis=int(axis), largest=False)
    from . import manipulation as man

    ax = int(axis)
    sel = tuple([slice(None)] * (ax % x.ndim) + [k - 1])
    vk = man._getitem(v, sel)
    ik = man._getitem(i, sel)
    if keepdim:
        vk = man.unsqueeze(vk, ax)
        ik = man.unsqueeze(ik, ax)
    return vk, ik


def _mode_values(v, axis):
    """The most frequent value along ``axis`` (keepdim), the smallest of
    equally frequent ones on every device: ``torch.mode`` breaks a tie in
    counts differently on the CPU and the card. Sorted, each value's count
    is its run's length, and argmax takes the first (smallest) run of the
    largest count."""
    s = torch.sort(v.movedim(axis, -1), dim=-1).values
    starts = torch.ones_like(s, dtype=torch.bool)
    starts[..., 1:] = s[..., 1:] != s[..., :-1]
    run = torch.cumsum(starts.long(), dim=-1) - 1
    counts = torch.zeros_like(run).scatter_add_(-1, run,
                                                torch.ones_like(run))
    best = torch.argmax(counts, dim=-1, keepdim=True)
    first = torch.argmax((run == best).to(torch.uint8), dim=-1, keepdim=True)
    return torch.gather(s, -1, first).movedim(-1, axis)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value (the smallest of equally frequent ones, as
    the JAX package's scipy mode) and the first index holding it."""
    v = plain(x)
    m = _mode_values(v, axis)
    idx = torch.argmax((v == m).to(torch.uint8), dim=axis, keepdim=True)
    if not keepdim:
        m, idx = m.squeeze(axis), idx.squeeze(axis)
    return wrap(m), wrap(idx.long())


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return wrap(torch.searchsorted(plain(sorted_sequence), plain(values),
                                   out_int32=out_int32, right=right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_sample(x, index):
    from .manipulation import index_sample as _is

    return _is(x, index)


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms

    return _ms(x, mask)


def where(condition, x=None, y=None, name=None):
    from .manipulation import where as _w

    return _w(condition, x, y)


def nonzero(x, as_tuple=False):
    from .manipulation import nonzero as _nz

    return _nz(x, as_tuple)
