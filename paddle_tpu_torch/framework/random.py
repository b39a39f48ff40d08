"""Global random state — port of ``paddle_tpu/framework/random.py``.

The JAX package keeps one process Generator holding a jax PRNG key that is
split on every draw. Here the state is PyTorch's: one ``torch.Generator``
per device type, created at first use, all reseeded by :func:`seed`, which
also calls ``torch.manual_seed`` so that ``nn.Dropout`` (PyTorch's own
global generators) replays from the same seed.

* The dense attention path draws its ``[b, h, sq, sk]`` keep-mask with
  ``torch.bernoulli`` from :func:`generator` of the tensors' device, where
  the JAX package draws ``jax.random.bernoulli(next_key(), ...)``.
* The flash kernels' in-kernel dropout (``csrc/philox.cuh``) is keyed by
  two 32-bit words from :func:`next_seed_words`, where the JAX package
  draws two words of a fresh key (``nn/functional/attention.py``).

Of the JAX module's names, ``seed``, ``Generator``, ``default_generator``,
``get_rng_state``, ``set_rng_state``, ``get_cuda_rng_state`` and
``set_cuda_rng_state`` keep their meaning. ``next_key`` (a jax key) and
``derive_scope`` (keys folded with traced scan ticks) have none here:
nothing is traced, and a draw advances the generator.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "Generator", "default_generator", "generator",
           "next_seed_words", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state"]

Generator = torch.Generator

_seed = 0
_generators: dict[str, torch.Generator] = {}


def generator(device="cpu"):
    """The port's generator of ``device``'s type (created at first use from
    the last :func:`seed`)."""
    kind = torch.device(device).type
    gen = _generators.get(kind)
    if gen is None:
        gen = torch.Generator(device=kind).manual_seed(_seed)
        _generators[kind] = gen
    return gen


def default_generator():
    """The host generator (the JAX package's ``default_generator``)."""
    return generator("cpu")


def seed(s: int):
    """``paddle.seed``: reseed the port's generators and PyTorch's global
    ones (``torch.manual_seed``, which ``nn.Dropout`` draws from)."""
    global _seed
    _seed = int(s)
    torch.manual_seed(_seed)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return default_generator()


def next_seed_words(device=None):
    """Two 32-bit words (Python ints in ``[0, 2^32)``) that key the flash
    kernels' Philox keep-mask for one attention call. They come from the
    host generator whatever ``device`` is, so a launch never waits on the
    card for its seed; fwd and bwd kernels regenerate one mask from them."""
    del device
    w = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                      generator=default_generator())
    return int(w[0]), int(w[1])


def get_rng_state():
    return default_generator().get_state()


def set_rng_state(state):
    default_generator().set_state(state)


def get_cuda_rng_state():
    return generator("cuda").get_state()


def set_cuda_rng_state(state):
    generator("cuda").set_state(state)
