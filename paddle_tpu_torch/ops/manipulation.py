"""Shape, layout and indexing — port of ``paddle_tpu/ops/manipulation.py``.

Scatters that write (``scatter`` with ``overwrite``, ``put_along_axis``,
``index_put`` and ``__setitem__``) give JAX's answer where indices repeat:
the last update of a position wins. Torch's CUDA ``index_put_`` promises no
order, so the port keeps only each position's last update before it
writes. ``unique``, ``nonzero`` and ``masked_select`` have a data-dependent
size and wait on the device, as in the JAX package.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework.tensor import check_inplace, wrap
from .dispatch import op, plain
from .math import operand

builtins_slice = builtins.slice
_TB = torch._C.TensorBase


def _ints(shape):
    if isinstance(shape, torch.Tensor):
        return [int(v) for v in plain(shape).reshape(-1).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(plain(s).item()) if isinstance(s, torch.Tensor) else int(s)
            for s in shape]


def _inplace(x, out):
    """Make ``x`` hold ``out`` (the JAX package rebinds): an in-place copy
    that autograd records, refused on a leaf that needs a gradient."""
    check_inplace(x)
    out = plain(out)
    if tuple(out.shape) != tuple(_TB.shape.__get__(x)):
        # a shape change: only a tensor off the graph can take it
        if x.requires_grad:
            raise RuntimeError("an in-place shape change of a Tensor on the "
                               "autograd graph is not supported by the port")
        _TB.set_(x, out.detach().clone())
        return x
    _TB.copy_(x, out)
    return x


@op("cast")
def _cast_raw(x, to_dtype=None):
    return x.to(to_dtype)


def cast(x, dtype):
    d = dtypes.convert_dtype(dtype)
    if x.dtype == d:
        return x
    return _cast_raw(x, to_dtype=d)


@op("reshape")
def _reshape_raw(x, shape=None):
    # Paddle's 0 keeps the input's size on that axis
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.reshape(x, shape)


def reshape(x, shape, name=None):
    return _reshape_raw(x, shape=tuple(_ints(shape)))


def reshape_(x, shape, name=None):
    return _inplace(x, reshape(x, shape))


@op("transpose")
def _transpose_raw(x, perm=None):
    return x.permute(perm)


def transpose(x, perm, name=None):
    return _transpose_raw(x, perm=tuple(int(p) for p in perm))


def t(x, name=None):
    if x.ndim < 2:
        return x
    return transpose(x, [1, 0])


@op("moveaxis")
def _moveaxis_raw(x, source=None, destination=None):
    return torch.movedim(x, source, destination)


def moveaxis(x, source, destination, name=None):
    def as_tup(v):
        return tuple(int(i) for i in np.atleast_1d(v))

    return _moveaxis_raw(x, source=as_tup(source),
                         destination=as_tup(destination))


@op("flatten")
def _flatten_raw(x, start_axis=0, stop_axis=-1):
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _flatten_raw(x, start_axis=start_axis, stop_axis=stop_axis)


@op("squeeze")
def _squeeze_raw(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(a % x.ndim for a in axis if x.shape[a % x.ndim] == 1)
    return torch.squeeze(x, axes) if axes else x.view_as(x)


def squeeze(x, axis=None, name=None):
    if axis is not None and not isinstance(axis, (list, tuple)):
        axis = [int(axis)]
    return _squeeze_raw(x, axis=tuple(axis) if axis is not None else None)


def squeeze_(x, axis=None, name=None):
    return _inplace(x, squeeze(x, axis))


@op("unsqueeze")
def _unsqueeze_raw(x, axis=()):
    for a in axis:
        x = torch.unsqueeze(x, a)
    return x


def unsqueeze(x, axis, name=None):
    if isinstance(axis, torch.Tensor):
        axis = _ints(axis)
    if not isinstance(axis, (list, tuple)):
        axis = [int(axis)]
    return _unsqueeze_raw(x, axis=tuple(int(a) for a in axis))


def unsqueeze_(x, axis, name=None):
    return _inplace(x, unsqueeze(x, axis))


@op("concat")
def _concat_raw(*xs, axis=0):
    return torch.cat(_same_dtype(xs), dim=axis)


def _same_dtype(xs):
    dt = xs[0].dtype
    for v in xs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return [v.to(dt) for v in xs]


def concat(x, axis=0, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(plain(axis).item())
    return _concat_raw(*x, axis=int(axis))


@op("stack")
def _stack_raw(*xs, axis=0):
    return torch.stack(_same_dtype(xs), dim=axis)


def stack(x, axis=0, name=None):
    return _stack_raw(*x, axis=int(axis))


@op("unstack_op")
def _unstack_raw(x, axis=0, num=None):
    if num is not None and num != x.shape[axis]:
        raise ValueError(f"unstack: num={num} but axis {axis} has "
                         f"{x.shape[axis]} entries")
    return tuple(torch.unbind(x, axis))


def unstack(x, axis=0, num=None):
    return list(_unstack_raw(x, axis=axis, num=num))


@op("split_op")
def _split_raw(x, sizes=None, axis=0):
    return tuple(torch.split(x, list(sizes), dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(plain(axis).item())
    axis = int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: axis {axis} of size {total} does not "
                             f"divide into {num_or_sections} equal parts")
        secs = [total // num_or_sections] * num_or_sections
    else:
        secs = _ints(num_or_sections)
        known = builtins.sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else total - known for s in secs]
    return list(_split_raw(x, sizes=tuple(secs), axis=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def vsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, axis=0)


def hsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, axis=1 if x.ndim > 1 else 0)


def dsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, axis=2)


@op("tile")
def _tile_raw(x, repeat_times=()):
    return torch.tile(x, repeat_times)


def tile(x, repeat_times, name=None):
    return _tile_raw(x, repeat_times=tuple(_ints(repeat_times)))


@op("expand")
def _expand_raw(x, shape=()):
    shape = list(shape)
    aligned = [1] * (len(shape) - x.ndim) + list(x.shape)
    out = [aligned[i] if shape[i] == -1 else shape[i]
           for i in range(len(shape))]
    return x.reshape(aligned).expand(out)


def expand(x, shape, name=None):
    return _expand_raw(x, shape=tuple(_ints(shape)))


def expand_as(x, y, name=None):
    return _expand_raw(x, shape=tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    out_shape = np.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [expand(t, out_shape) for t in inputs]


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@op("flip")
def _flip_raw(x, axis=()):
    return torch.flip(x, axis)


def flip(x, axis, name=None):
    if not isinstance(axis, (list, tuple)):
        axis = [axis]
    return _flip_raw(x, axis=tuple(int(a) for a in axis))


@op("rot90")
def _rot90_raw(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, axes)


def rot90(x, k=1, axes=(0, 1), name=None):
    return _rot90_raw(x, k=k, axes=tuple(axes))


@op("roll")
def _roll_raw(x, shifts=None, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, torch.Tensor):
        shifts = _ints(shifts)
        shifts = shifts[0] if len(shifts) == 1 else tuple(shifts)
    elif isinstance(shifts, (list, tuple)):
        shifts = tuple(int(s) for s in shifts)
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    return _roll_raw(x, shifts=shifts, axis=axis)


# ------------------------------------------------------------- indexing -----


def _index(idx, device):
    """An index expression for torch: tensors as plain int64 (bool masks
    kept), numpy arrays and integer lists as tensors on ``device``."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    out = []
    for it in idx:
        if isinstance(it, torch.Tensor):
            v = plain(it)
            out.append(v if v.dtype == torch.bool else v.long())
        elif isinstance(it, np.ndarray) or (
                isinstance(it, list) and it
                and not isinstance(it[0], (builtins_slice, type(None)))):
            out.append(torch.as_tensor(np.asarray(it), device=device))
        else:
            out.append(it)
    return tuple(out)


@op("getitem")
def _getitem_raw(x, *index_tensors, idx_spec=None):
    it = iter(index_tensors)
    idx = tuple(next(it) if s is _TENSOR_SLOT else s for s in idx_spec)
    return x[idx]


class _Slot:
    pass


_TENSOR_SLOT = _Slot()


def _split_index(idx, device):
    spec, tensors = [], []
    for v in _index(idx, device):
        if isinstance(v, torch.Tensor):
            tensors.append(v)
            spec.append(_TENSOR_SLOT)
        else:
            spec.append(v)
    return tuple(spec), tensors


def _getitem(x, idx):
    spec, tensors = _split_index(idx, x.device)
    return _getitem_raw(x, *tensors, idx_spec=spec)


def _target_positions(x, idx):
    """Flat positions of ``x`` that ``x[idx]`` reads, shaped as ``x[idx]``."""
    pos = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    return pos[idx]


def _set_last_wins(x, pos, values):
    """``x`` with ``values`` written at flat positions ``pos``, the last
    update of a repeated position winning, as a differentiable function of
    ``x`` and ``values``. Every update of a repeated position writes the
    winner's value (detached but the winner's own), so the write is the
    same in any order and only the winner gets a gradient; nothing waits on
    the device."""
    values = values.to(x.dtype).expand(pos.shape)
    flat_pos = pos.reshape(-1)
    order = torch.arange(flat_pos.numel(), device=x.device)
    winner = torch.full((x.numel(),), -1, dtype=torch.long, device=x.device)
    winner = winner.scatter_reduce(0, flat_pos, order, reduce="amax")
    win = winner[flat_pos]
    flat_v = values.reshape(-1)
    eff = torch.where(win == order, flat_v, flat_v[win].detach())
    return x.reshape(-1).index_put((flat_pos,), eff).reshape(x.shape)


@op("setitem")
def _setitem_raw(x, v, *index_tensors, idx_spec=None):
    it = iter(index_tensors)
    idx = tuple(next(it) if s is _TENSOR_SLOT else s for s in idx_spec)
    pos = _target_positions(x, idx)
    v = v.to(x.dtype)
    if tuple(v.shape) != tuple(pos.shape):
        # paddle assigns e.g. shape-(1,) values into scalar slots
        while v.ndim > pos.ndim and v.shape[0] == 1:
            v = v.reshape(v.shape[1:])
        v = v.expand(pos.shape)
    return _set_last_wins(x, pos, v)


def _setitem_(x, idx, value):
    """``x[idx] = value``: the JAX package's functional scatter, then an
    in-place copy into ``x``."""
    spec, tensors = _split_index(idx, x.device)
    value = operand(value, x) if not isinstance(value, torch.Tensor) else value
    return _inplace(x, _setitem_raw(x, value, *tensors, idx_spec=spec))


@op("slice_op")
def _slice_raw(x, axes=(), starts=(), ends=()):
    idx = [builtins_slice(None)] * x.ndim
    for a, s, e in zip(axes, starts, ends):
        idx[a] = builtins_slice(s, e)
    return x[tuple(idx)]


def slice(x, axes, starts, ends):  # noqa: A001
    return _slice_raw(x, axes=tuple(_ints(axes)), starts=tuple(_ints(starts)),
                      ends=tuple(_ints(ends)))


def strided_slice(x, axes, starts, ends, strides, name=None):
    out = x
    for a, st, e, step in zip(_ints(axes), _ints(starts), _ints(ends),
                              _ints(strides)):
        ids = list(range(x.shape[a]))[builtins_slice(st, e, step)]
        out = index_select(out, torch.tensor(ids, device=x.device), axis=a)
    return out


@op("gather")
def _gather_raw(x, index, axis=0):
    return torch.index_select(x, axis, index.reshape(-1).long())


def gather(x, index, axis=0, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(plain(axis).item())
    return _gather_raw(x, _as_index(index, x), axis=int(axis))


def _as_index(index, like):
    if isinstance(index, torch.Tensor):
        return index
    return torch.as_tensor(np.asarray(index), device=like.device)


@op("gather_nd")
def _gather_nd_raw(x, index):
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def gather_nd(x, index, name=None):
    return _gather_nd_raw(x, _as_index(index, x))


@op("take_along_axis")
def _take_along_axis_raw(x, indices, axis=0, broadcast=True):
    indices = indices.long()
    if broadcast:
        tgt = list(x.shape)
        tgt[axis] = (indices.shape[axis] if indices.ndim == x.ndim
                     else indices.shape[-1])
        indices = indices.expand(tgt)
    return torch.take_along_dim(x, indices, dim=axis)


def take_along_axis(arr, indices, axis, broadcast=True):
    return _take_along_axis_raw(arr, indices, axis=axis, broadcast=broadcast)


def _along_positions(x, indices, axis):
    """Flat (row-major) positions of ``x`` that ``put_along_axis``
    writes."""
    grid = list(torch.meshgrid(*[torch.arange(s, device=x.device)
                                 for s in indices.shape], indexing="ij"))
    grid[axis] = indices
    strides = [int(np.prod(x.shape[d + 1:])) for d in range(x.ndim)]
    return builtins.sum(g * s for g, s in zip(grid, strides))


@op("put_along_axis")
def _put_along_axis_raw(x, indices, values, axis=0, reduce="assign",
                        include_self=True, bshape=None):
    indices = indices.long()
    if bshape is not None:
        if indices.ndim != x.ndim:
            indices = indices.reshape(
                [-1 if i == axis else 1 for i in range(x.ndim)])
        indices = indices.expand(bshape)
        values = values.expand(bshape)
    pos = _along_positions(x, indices, axis)
    if reduce == "assign":
        return _set_last_wins(x, pos, values)
    if reduce in ("add", "sum"):
        base = x if include_self else _set_last_wins(
            x, pos, torch.zeros_like(values))
        return base + torch.zeros_like(x).reshape(-1).index_put(
            (pos.reshape(-1),), values.to(x.dtype).reshape(-1),
            accumulate=True).reshape(x.shape)
    raise NotImplementedError(f"put_along_axis reduce={reduce}")


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True):
    values = operand(values, arr)
    bshape = None
    if broadcast:
        tgt = list(arr.shape)
        tgt[axis] = (indices.shape[axis] if len(indices.shape) == len(tgt)
                     else 1)
        bshape = tuple(tgt)
    return _put_along_axis_raw(arr, indices, values, axis=axis,
                               reduce=reduce, include_self=include_self,
                               bshape=bshape)


def _row_positions(x, index):
    """Flat positions of the rows ``x[index]`` (index over axis 0)."""
    row = int(np.prod(x.shape[1:])) if x.ndim > 1 else 1
    base = index.reshape(-1, *([1] * (x.ndim - 1))) * row
    inner = torch.arange(row, device=x.device).reshape(
        1, *x.shape[1:]) if x.ndim > 1 else torch.zeros(
        1, dtype=torch.long, device=x.device)
    return base + inner


@op("scatter")
def _scatter_raw(x, index, updates, overwrite=True):
    index = index.reshape(-1).long()
    pos = _row_positions(x, index)
    if overwrite:
        return _set_last_wins(x, pos, updates)
    base = _set_last_wins(x, pos, torch.zeros_like(updates))
    return base.index_add(0, index, updates.to(x.dtype))


def scatter(x, index, updates, overwrite=True, name=None):
    return _scatter_raw(x, _as_index(index, x), updates, overwrite=overwrite)


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite))


@op("scatter_nd_add")
def _scatter_nd_add_raw(x, index, updates):
    idx = tuple(torch.movedim(index.long(), -1, 0))
    return x.index_put(idx, updates.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return _scatter_nd_add_raw(x, _as_index(index, x), updates)


def scatter_nd(index, updates, shape, name=None):
    from . import creation

    zeros = creation.zeros(shape, dtype=updates.dtype)
    return scatter_nd_add(zeros, index, updates)


@op("index_select")
def _index_select_raw(x, index, axis=0):
    return torch.index_select(x, axis, index.reshape(-1).long())


def index_select(x, index, axis=0, name=None):
    return _index_select_raw(x, _as_index(index, x), axis=axis)


@op("index_sample")
def _index_sample_raw(x, index):
    return torch.gather(x, 1, index.long())


def index_sample(x, index):
    return _index_sample_raw(x, _as_index(index, x))


@op("index_add")
def _index_add_raw(x, index, value, axis=0):
    return torch.index_add(x, axis, index.long(), value.to(x.dtype))


def index_add(x, index, axis, value, name=None):
    return _index_add_raw(x, _as_index(index, x), value, axis=axis)


@op("index_put_add")
def _index_put_add_raw(x, v, *index_tensors, idx_spec=None):
    it = iter(index_tensors)
    idx = tuple(next(it) if s is _TENSOR_SLOT else s for s in idx_spec)
    return x.index_put(idx, v.to(x.dtype), accumulate=True)


def index_put(x, indices, value, accumulate=False, name=None):
    spec, tensors = _split_index(tuple(indices), x.device)
    value = operand(value, x)
    if accumulate:
        return _index_put_add_raw(x, value, *tensors, idx_spec=spec)
    return _setitem_raw(x, value, *tensors, idx_spec=spec)


@op("masked_select_sized")
def _masked_select_raw(x, mask):
    return torch.masked_select(x, mask.bool())


def masked_select(x, mask, name=None):
    return _masked_select_raw(x, mask)


@op("masked_fill")
def _masked_fill_raw(x, mask, value):
    return torch.where(mask.bool(), value.to(x.dtype), x)


def masked_fill(x, mask, value, name=None):
    return _masked_fill_raw(x, _as_index(mask, x), operand(value, x))


def masked_fill_(x, mask, value, name=None):
    return _inplace(x, masked_fill(x, mask, value))


@op("fill_diagonal")
def _fill_diagonal_raw(x, value=0.0, offset=0, wrap=False):
    n = builtins.min(x.shape[0], x.shape[1])
    i = torch.arange(n - builtins.abs(offset), device=x.device)
    r = i if offset >= 0 else i - offset
    c = i + offset if offset >= 0 else i
    out = x.clone()
    out[r, c] = torch.tensor(value, dtype=x.dtype, device=x.device)
    return out


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    return _inplace(x, _fill_diagonal_raw(x, value=value, offset=offset,
                                          wrap=wrap))


@op("where")
def _where_raw(cond, x, y):
    return torch.where(cond.bool(), x, y)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    if not isinstance(x, torch.Tensor):
        x = operand(x, y)
    y = operand(y, x)
    return _where_raw(condition, x, y)


def nonzero(x, as_tuple=False):
    """Data-dependent size: waits on the device, as in the JAX package."""
    idx = torch.nonzero(plain(x))
    if as_tuple:
        return tuple(wrap(i) for i in idx.unbind(1))
    return wrap(idx)


# ---------------------------------------------------------------- pad -------


@op("pad_nd")
def _pad_raw(x, pad=(), mode="constant", value=0.0):
    if mode == "constant":
        flat = [w for pair in reversed(pad) for w in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    padded = [d for d, w in enumerate(pad) if w != (0, 0)]
    if not padded:
        return x
    if x.ndim in (3, 4, 5) and padded[0] >= 2:
        # the spatial axes of [N, C, *spatial]: torch's own form, which
        # keeps a channels-last input channels-last
        flat = [w for pair in reversed(pad[2:]) for w in pair]
        return torch.nn.functional.pad(x, flat, mode=mode)
    # torch pads the trailing 1-3 axes of a batched input: move the padded
    # axes last, fold the others into one batch axis
    rest = [d for d in range(x.ndim) if d not in padded]
    y = x.permute(rest + padded)
    lead = y.shape[:len(rest)]
    y = y.reshape(1, -1, *y.shape[len(rest):])
    flat = [w for d in reversed(padded) for w in pad[d]]
    y = torch.nn.functional.pad(y, flat, mode=mode)
    y = y.reshape(*lead, *y.shape[2:])
    inv = np.argsort(rest + padded).tolist()
    return y.permute(inv)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        name=None):  # noqa: A001
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pad) // 2
        width = [(0, 0)] * nd
        if data_format.endswith("C") and nd >= 3:
            spatial = list(range(1, 1 + k))
        else:
            spatial = list(range(nd - k, nd))
        for j, d in enumerate(spatial):
            width[d] = (pad[2 * j], pad[2 * j + 1])
    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "replicate", "circular": "circular"}[mode]
    return _pad_raw(x, pad=tuple(width), mode=tmode, value=value)


# ------------------------------------------------------------- misc ---------


@op("repeat_interleave")
def _repeat_interleave_raw(x, repeats=None, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    if not isinstance(repeats, torch.Tensor):
        repeats = int(repeats)
    return _repeat_interleave_raw(x, repeats=repeats, axis=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``'s answer, computed where ``x`` lies: the sorted unique
    values (slices along ``axis``), then as asked the index of each one's
    first occurrence, the inverse (flat) and the counts. Only the number of
    unique values reaches the host."""
    v = plain(x).detach()
    if axis is None:
        v = v.reshape(-1)
    ax = 0 if axis is None else axis % v.ndim
    out, inv, cnt = torch.unique(v, sorted=True, return_inverse=True,
                                 return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return wrap(out)
    res = [out]
    if return_index:
        n = v.shape[ax]
        first = torch.full((out.shape[ax],), n, dtype=torch.int64,
                           device=v.device)
        res.append(first.scatter_reduce(
            0, inv.reshape(-1), torch.arange(n, device=v.device), "amin"))
    if return_inverse:
        res.append(inv.reshape(-1))
    if return_counts:
        res.append(cnt)
    it = dtypes.convert_dtype(dtype)
    return tuple(wrap(r if i == 0 else r.to(it)) for i, r in enumerate(res))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    out = torch.unique_consecutive(plain(x), return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(out, tuple):
        return wrap(out)
    return tuple(wrap(o if i == 0 else o.reshape(-1).to(
        dtypes.convert_dtype(dtype))) for i, o in enumerate(out))


@op("as_real")
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@op("as_complex")
def as_complex(x):
    if x.dtype in dtypes.LOW_PRECISION:
        x = x.float()   # torch has no complex type of a 2-byte float
    return torch.complex(x[..., 0], x[..., 1])


def numel(x, name=None):
    return wrap(torch.tensor(int(np.prod(x.shape)), dtype=torch.int64,
                             device=x.device))


def shape(x):
    return wrap(torch.tensor(list(x.shape), dtype=torch.int32,
                             device=x.device))


def rank(x):
    return wrap(torch.tensor(x.ndim, dtype=torch.int32, device=x.device))


def is_empty(x, name=None):
    return wrap(torch.tensor(int(np.prod(x.shape)) == 0, device=x.device))


@op("increment")
def _increment_raw(x, value=1.0):
    return x + value


def increment(x, value=1.0, name=None):
    return _inplace(x, _increment_raw(x, value=value))


def tolist(x):
    return plain(x).tolist()


def crop(x, shape=None, offsets=None, name=None):
    shape = _ints(shape)
    offsets = _ints(offsets) if offsets is not None else [0] * x.ndim
    idx = tuple(builtins_slice(o, o + s if s != -1 else None)
                for o, s in zip(offsets, shape))
    return _getitem(x, idx)


def reverse(x, axis, name=None):
    """The legacy ``reverse``: ``flip``."""
    return flip(x, axis)


def unbind(input, axis=0, name=None):
    return unstack(input, axis=int(axis))


@op("shard_index")
def _shard_index_raw(x, index_num=0, nshards=1, shard_id=0, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    in_shard = (x >= lo) & (x < lo + shard_size)
    return torch.where(in_shard, x - lo, torch.full_like(x, ignore_value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Global indices to shard-local offsets, ``ignore_value`` outside
    this shard."""
    if shard_id < 0 or shard_id >= nshards:
        raise ValueError(
            f"shard_id({shard_id}) should be in [0, {nshards})")
    return _shard_index_raw(input, index_num=int(index_num),
                            nshards=int(nshards), shard_id=int(shard_id),
                            ignore_value=int(ignore_value))

