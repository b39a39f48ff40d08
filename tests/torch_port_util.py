"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The same seeded weights go into the JAX model and the port
(``paddle_tpu_torch.models.load_jax_state``), both run on the CPU, and the
tests compare their outputs.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

#: fp32 tolerance of the parity tests: both packages compute the same
#: fp32 arithmetic in other orders (XLA:CPU vs PyTorch's CPU kernels)
FP32_TOL = 1e-5


@pytest.fixture
def no_persistent_compile_cache():
    """Compile every JAX executable in process: executables round-tripped
    through the persistent XLA:CPU compile cache are not bit-identical to
    in-process compiles on this stack (``tests/test_serving.py``)."""
    import jax

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


@contextlib.contextmanager
def jax_flags(**flags):
    """Set JAX-package flags for the block, restoring them after."""
    import paddle_tpu as paddle

    prev = paddle.get_flags(list(flags))
    paddle.set_flags(flags)
    try:
        yield
    finally:
        paddle.set_flags(prev)


@contextlib.contextmanager
def port_flags(**flags):
    """Set the port's flags for the block, restoring them after."""
    from paddle_tpu_torch.framework import get_flags, set_flags

    prev = get_flags(list(flags))
    set_flags(flags)
    try:
        yield
    finally:
        set_flags(prev)


@contextlib.contextmanager
def both_flags(**flags):
    with jax_flags(**flags), port_flags(**flags):
        yield


def gpt_pair(seed=0, vocab=97, hidden=128, layers=2, heads=2, max_pos=256,
             init_std=0.3):
    """``(jax_model, port_model)``: a seeded JAX GPT and the port's GPT on
    the CPU holding the same weights, both in eval mode. ``init_std`` is
    well above GPT-2's 0.02 so that a random model's greedy streams vary
    from token to token instead of repeating one token."""
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    from paddle_tpu.utils import unique_name

    import paddle_tpu_torch.models as pm

    kw = dict(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
              num_heads=heads, max_position_embeddings=max_pos,
              hidden_dropout=0.0, attention_dropout=0.0,
              initializer_range=init_std)
    with unique_name.guard():
        paddle.seed(seed)
        jm = GPTForCausalLM(GPTConfig(**kw))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = pm.GPTForCausalLM(pm.GPTConfig(**kw), device="cpu")
    pm.load_jax_state(tm, state)
    tm.eval()
    return jm, tm


def jax_state(jax_model):
    """The JAX model's ``state_dict()`` as ``{name: numpy array}``."""
    return {k: np.asarray(v.numpy()) for k, v in jax_model.state_dict().items()}


def model_pair(jax_ctor, port_ctor, seed=0):
    """``(jax_model, port_model)``: ``jax_ctor()`` built from
    ``paddle.seed(seed)`` and ``port_ctor(device="cpu")`` holding the same
    weights (``load_jax_state``), both in eval mode."""
    import paddle_tpu as paddle
    from paddle_tpu.utils import unique_name

    import paddle_tpu_torch.models as pm

    from paddle_tpu.optimizer.optimizer import Optimizer

    with unique_name.guard():
        paddle.seed(seed)
        jm = jax_ctor()
        # a stacked layer's deep copies carry no names; a JAX optimizer
        # names them at its first step from the global generator, where the
        # names clash with this guard's: name them here, in its order
        for p in jm.parameters():
            Optimizer._pkey(p)
    jm.eval()
    tm = port_ctor(device="cpu")
    pm.load_jax_state(tm, jax_state(jm))
    tm.eval()
    return jm, tm


def grads_match(jax_model, port_model, atol=1e-5, rtol=1e-4):
    """Every parameter's gradient of the port within ``atol`` + ``rtol``
    relative of JAX's, element by element (paddle's Linear weights are
    ``[in, out]``: transposed); a parameter off the loss's path has none in
    either."""
    from paddle_tpu_torch.models.convert import _linear_weights

    linear = _linear_weights(port_model)
    jgrads = {n: p.grad for n, p in jax_model.named_parameters()}
    tparams = dict(port_model.named_parameters())
    assert set(jgrads) == set(tparams)
    for name, p in tparams.items():
        if jgrads[name] is None:            # not on the loss's path
            assert p.grad is None, name
            continue
        want = np.asarray(jgrads[name].numpy(), np.float32)
        if name in linear:
            want = want.T
        np.testing.assert_allclose(p.grad.float().numpy(), want, atol=atol,
                                   rtol=rtol, err_msg=name)
