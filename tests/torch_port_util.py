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
    relative of JAX's, element by element (both packages keep Paddle's
    layouts); a parameter off the loss's path has none in either."""
    jgrads = {n: p.grad for n, p in jax_model.named_parameters()}
    tparams = dict(port_model.named_parameters())
    assert set(jgrads) == set(tparams)
    for name, p in tparams.items():
        if jgrads[name] is None:            # not on the loss's path
            assert p.grad is None, name
            continue
        want = np.asarray(jgrads[name].numpy(), np.float32)
        np.testing.assert_allclose(p.grad.float().numpy(), want, atol=atol,
                                   rtol=rtol, err_msg=name)


@pytest.fixture
def port_cpu():
    """The port's current place set to the CPU for one test (``set_device``
    leaves it there otherwise: a Layer built without ``device`` lands on
    it), and put back after."""
    from paddle_tpu_torch.framework import place

    prev = place._current
    place.set_device("cpu")
    yield
    place._current = prev


@contextlib.contextmanager
def default_place():
    """The port's current place at its start, ``gpu:0`` (a card that may
    not be there), inside a test that runs on the CPU place."""
    from paddle_tpu_torch.framework import place

    prev = place._current
    place._current = place.CUDAPlace(0)
    try:
        yield
    finally:
        place._current = prev


# -- the op sweep (paddle_tpu_torch/ops/op_table.py) against the JAX package --

#: forward values in fp32: within this share of the largest magnitude
SWEEP_FWD_TOL = 1e-5
#: gradients in fp32 (a product and a sum on top of the forward)
SWEEP_GRAD_TOL = 1e-4
#: the linalg entries (LAPACK's routines in both packages, fp32)
SWEEP_LINALG_TOL = 1e-3


def sweep_arrays(entry):
    """An entry's inputs from ``RandomState(crc32(api))``, as the JAX
    package's sweep seeds them."""
    import zlib

    from paddle_tpu_torch.ops.op_table import draw

    rng = np.random.RandomState(zlib.crc32(entry["api"].encode()) % 2 ** 31)
    return [draw(s, d, rng) for s, d in entry["inputs"]]


def jax_sweep_run(entry, arrays, dtype=None, seed=0):
    """:func:`paddle_tpu_torch.ops.op_table.run` through the JAX package."""
    import paddle_tpu as jp
    from paddle_tpu.framework.tensor import Tensor as JT

    from paddle_tpu_torch.ops.op_table import differentiable_inputs, resolve

    fn = resolve(entry["api"], jp)
    diff = differentiable_inputs(entry)
    tensors = []
    for i, a in enumerate(arrays):
        t = JT(a)
        if dtype is not None and a.dtype == np.float32:
            t = t.astype(dtype)
        t.stop_gradient = i not in diff
        tensors.append(t)
    out = fn(*tensors, **entry["kwargs"])
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = None
    if diff and not outs[0].stop_gradient:
        c = np.random.RandomState(seed).uniform(-1, 1, outs[0].shape)
        ct = JT(c.astype(np.float32)).astype(outs[0].dtype)
        loss = jp.sum(outs[0] * ct)
        grads = jp.grad(loss, [tensors[i] for i in diff], allow_unused=True)
        grads = [None if g is None else _f32(g.numpy()) for g in grads]
    return [_f32(o.numpy()) for o in outs], grads


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(
        a.dtype) == "bfloat16" else a


def sweep_close(got, want, tol, what):
    """``got`` within ``tol`` of the largest magnitude of ``want`` (exact
    for integers and booleans; NaN and Inf where ``want`` has them)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    if fin.any():
        scale = max(np.abs(want[fin]).max(), 1e-30)
        err = np.abs(got[fin] - want[fin]).max()
        assert err <= tol * scale, f"{what}: {err:.3g} > {tol} x {scale:.3g}"


def _slice_reference(entry, arrays, seed=0):
    """``ops.slice`` by numpy: the JAX package's ``slice`` raises (its
    ``_slice_raw``, ``paddle_tpu/ops/manipulation.py:374``, calls the
    module's own ``slice`` where it means the builtin)."""
    x = arrays[0]
    kw = entry["kwargs"]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(kw["axes"], kw["starts"], kw["ends"]):
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    grad = np.zeros_like(x)
    grad[tuple(idx)] = np.random.RandomState(seed).uniform(
        -1, 1, out.shape).astype(np.float32)
    return [out], [grad]


#: entries whose reference is numpy, with the JAX fault that forces it
JAX_FAULTY = {"ops.slice": _slice_reference}


def sweep_check(entry):
    """One entry, fp32, forward and gradient: the port on the CPU against
    the JAX package."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import op_table

    arrays = sweep_arrays(entry)
    outs, grads = op_table.run(entry, arrays, pt, "cpu")
    ref = JAX_FAULTY.get(entry["api"], None)
    jouts, jgrads = (ref(entry, arrays) if ref is not None
                     else jax_sweep_run(entry, arrays))
    lin = entry["api"] in op_table.LINALG
    ftol = SWEEP_LINALG_TOL if lin else SWEEP_FWD_TOL
    gtol = SWEEP_LINALG_TOL if lin else SWEEP_GRAD_TOL
    assert len(outs) == len(jouts), entry["api"]
    for i, (o, j) in enumerate(zip(outs, jouts)):
        sweep_close(o, j, ftol, f"{entry['api']} output {i}")
    assert (grads is None) == (jgrads is None), entry["api"]
    for i, (g, j) in enumerate(zip(grads or [], jgrads or [])):
        assert (g is None) == (j is None), (entry["api"], i)
        if g is not None:
            sweep_close(g, j, gtol, f"{entry['api']} grad {i}")


def sweep_ids(entries):
    counts, out = {}, []
    for e in entries:
        n = e["api"]
        counts[n] = counts.get(n, 0) + 1
        out.append(n if counts[n] == 1 else f"{n}#{counts[n]}")
    return out


def twin_check(jax_fn, port_fn, arrays, diff=(0,), tol=FP32_TOL, seed=0):
    """``jax_fn`` and ``port_fn`` (each taking its package's Tensors) on the
    same numpy ``arrays``: every output within ``tol`` of the largest
    magnitude of the JAX one, and the gradients of ``sum(out * c)`` (``c``
    from ``RandomState(seed)``, ``out`` the first output) with respect to
    the inputs ``diff`` within ``10 * tol``."""
    import paddle_tpu as jp
    from paddle_tpu.framework.tensor import Tensor as JT

    import paddle_tpu_torch as pt

    jin, tin = [], []
    for i, a in enumerate(arrays):
        j, t = JT(a), pt.to_tensor(a, place="cpu")
        j.stop_gradient = t.stop_gradient = i not in diff
        jin.append(j)
        tin.append(t)
    jout, tout = jax_fn(*jin), port_fn(*tin)
    jouts = list(jout) if isinstance(jout, (tuple, list)) else [jout]
    touts = list(tout) if isinstance(tout, (tuple, list)) else [tout]
    assert len(jouts) == len(touts)
    for i, (j, t) in enumerate(zip(jouts, touts)):
        sweep_close(t.numpy(), _f32(j.numpy()), tol, f"output {i}")
    if not diff:
        return touts
    c = np.random.RandomState(seed).uniform(
        -1, 1, tuple(touts[0].shape)).astype(np.float32)
    jg = jp.grad(jp.sum(jouts[0] * JT(c)), [jin[i] for i in diff],
                 allow_unused=True)
    tg = pt.grad(pt.sum(touts[0] * pt.to_tensor(c, place="cpu")),
                 [tin[i] for i in diff], allow_unused=True)
    for i, (j, t) in zip(diff, zip(jg, tg)):
        assert (j is None) == (t is None), f"grad {i}"
        if t is not None:
            sweep_close(t.numpy(), _f32(j.numpy()), 10 * tol, f"grad {i}")
    return touts


#: how far a JAX training run may stand from the port's fp32 run, in
#: multiples of the port's own fp32 rounding spread (its distance from the
#: same steps in fp64)
SPREAD = 10.0


def spread_check(got, jax_val, f64, name, scale=None):
    """||port32 - JAX|| <= SPREAD · ||port32 - port64|| + 1e-6 · scale,
    ``scale`` by default ||port64||. A quantity that is zero in exact
    arithmetic is rounding noise in both packages; its caller passes the
    scale the noise comes from."""
    got, f64 = np.asarray(got, np.float64), np.asarray(f64, np.float64)
    gap = np.linalg.norm(got - np.asarray(jax_val, np.float64))
    spread = np.linalg.norm(got - f64)
    scale = np.linalg.norm(f64) if scale is None else scale
    assert gap <= SPREAD * spread + 1e-6 * scale, (
        f"{name}: {gap:.3g} from JAX, fp32 spread {spread:.3g}")
