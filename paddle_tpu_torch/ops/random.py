"""Random ops — port of ``paddle_tpu/ops/random.py``.

Draws come from the port's generators (``framework/random.py``: one
``torch.Generator`` per device type, reseeded by ``paddle.seed``), on the
current place. They replay under one seed within the port, but they are not
the JAX package's draws (a jax key split per draw), as for dropout.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework import random as rnd
from ..framework.place import current_device
from ..framework.tensor import wrap
from .creation import _dt, _shape_list, _val
from .dispatch import plain

_TB = torch._C.TensorBase


def _gen(device, seed=0):
    if seed:
        return torch.Generator(device=torch.device(device).type).manual_seed(
            int(seed))
    return rnd.generator(device)


def rand(shape, dtype=None, name=None):
    dev = current_device()
    return wrap(torch.rand(_shape_list(shape), dtype=_dt(dtype), device=dev,
                           generator=_gen(dev)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    out = torch.empty(_shape_list(shape), dtype=_dt(dtype), device=dev)
    return wrap(out.uniform_(_val(min), _val(max), generator=_gen(dev, seed)))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        _TB.uniform_(x, _val(min), _val(max), generator=_gen(x.device, seed))
    return x


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return wrap(torch.randn(_shape_list(shape), dtype=_dt(dtype), device=dev,
                            generator=_gen(dev)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, s = plain(mean), plain(std)
        like = m if isinstance(m, torch.Tensor) else s
        sh = torch.broadcast_shapes(getattr(m, "shape", ()),
                                    getattr(s, "shape", ()))
        z = torch.randn(sh, dtype=like.dtype, device=like.device,
                        generator=_gen(like.device))
        return wrap(z * s + m)
    dev = current_device()
    sh = _shape_list(shape) if shape is not None else []
    z = torch.randn(sh, dtype=_dt(None), device=dev, generator=_gen(dev))
    return wrap(z * std + mean)


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        _TB.normal_(x, mean, std, generator=_gen(x.device))
    return x


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current_device()
    out = torch.empty(_shape_list(shape), dtype=_dt(dtype), device=dev)
    return wrap(out.normal_(mean, std, generator=_gen(dev, seed)))


def randint(low=0, high=None, shape=[1], dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return wrap(torch.randint(int(low), int(high), _shape_list(shape),
                              device=dev, generator=_gen(dev)).to(
        dtypes.convert_dtype(dtype)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return wrap(torch.randint(int(low), int(high), tuple(x.shape),
                              device=x.device, generator=_gen(x.device)).to(
        dtypes.convert_dtype(dtype or "int64")))


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return wrap(torch.randperm(int(n), device=dev, generator=_gen(dev)).to(
        dtypes.convert_dtype(dtype)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    v = plain(x)
    return wrap(torch.multinomial(v, num_samples, replacement,
                                  generator=_gen(v.device)))


def bernoulli(x, name=None):
    v = plain(x)
    return wrap(torch.bernoulli(v, generator=_gen(v.device)))


def poisson(x, name=None):
    v = plain(x)
    return wrap(torch.poisson(v, generator=_gen(v.device)))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        _TB.exponential_(x, lam, generator=_gen(x.device))
    return x


def binomial(count, prob, name=None):
    c, p = plain(count), plain(prob)
    like = c if isinstance(c, torch.Tensor) else p
    c = torch.as_tensor(c, dtype=torch.float32, device=like.device)
    p = torch.as_tensor(p, dtype=torch.float32, device=like.device)
    c, p = torch.broadcast_tensors(c, p)
    return wrap(torch.binomial(c, p, generator=_gen(like.device)).long())


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    return wrap(torch.exp(plain(normal(mean, std, shape))))
