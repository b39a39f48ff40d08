"""The port's ``fused_linear_cross_entropy`` against the JAX package's, on the
CPU, fp32: value and gradients (hidden, weight, bias), ``ignore_index``,
the three reductions, and token counts that are not a multiple of the
chunk. The JAX side runs both of its routes: the chunked scan
(``_FORCE_PALLAS = False``, its default on hardware) and the Pallas
flash-CE kernels K9–K11 in interpret mode (its default there); the port
always runs its chunked loop.

Tolerance: values to 1e-5 relative, gradients to 2e-5 absolute
(``tests/test_fused_ce.py``'s: the same fp32 arithmetic in another order).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.ops import fused as jax_fused
from paddle_tpu.ops.pallas import interpret_mode

import paddle_tpu_torch.nn.functional as PF
from tests.torch_port_util import no_persistent_compile_cache, port_flags  # noqa: F401

VALUE_RTOL = 1e-5
GRAD_ATOL = 2e-5

# tokens, vocab, chunk, bias, every 5th label ignored, reduction; one
# (tokens, vocab) shape, so the JAX side compiles each route once
_CASES = [
    (300, 97, 128, False, True, "mean"),    # 300 = 2 chunks of 128 + 44
    (300, 97, 0, True, False, "sum"),       # auto chunk: 256 + 44
    (300, 97, 128, True, True, "none"),
]
HIDDEN = 128  # a multiple of 128, so interpret mode reaches K9-K11


def _inputs(tokens, vocab, ignore, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(tokens, HIDDEN).astype(np.float32)
    w = (rng.randn(vocab, HIDDEN) * 0.05).astype(np.float32)
    b = (rng.randn(vocab) * 0.1).astype(np.float32)
    y = rng.randint(0, vocab, (tokens,)).astype(np.int64)
    if ignore:
        y[::5] = -100
    co = rng.randn(tokens).astype(np.float32)
    return h, w, b, y, co


@pytest.mark.parametrize("route", ["scan", "pallas"])
@pytest.mark.parametrize("tokens,vocab,chunk,use_bias,ignore,reduction",
                         _CASES)
def test_value_and_grads_match_jax(route, tokens, vocab, chunk, use_bias,
                                   ignore, reduction, monkeypatch,
                                   no_persistent_compile_cache):
    h, w, b, y, co = _inputs(tokens, vocab, ignore)
    if route == "scan":
        monkeypatch.setattr(jax_fused, "_FORCE_PALLAS", False)
        ctx = contextlib.nullcontext()
    else:
        ctx = interpret_mode()
    with ctx:
        jh, jw = (Tensor(a, stop_gradient=False) for a in (h, w))
        jb = Tensor(b, stop_gradient=False) if use_bias else None
        out = JF.fused_linear_cross_entropy(jh, jw, Tensor(y), jb,
                                            reduction=reduction, chunk=chunk)
        want = np.asarray(out._value)
        (out * Tensor(co) if reduction == "none" else out).sum().backward()
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tb = torch.from_numpy(b).requires_grad_() if use_bias else None
    got = PF.fused_linear_cross_entropy(th, tw, torch.from_numpy(y), tb,
                                        reduction=reduction, chunk=chunk)
    (got * torch.from_numpy(co) if reduction == "none" else got).sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE_RTOL,
                               atol=VALUE_RTOL)
    pairs = [(th, jh), (tw, jw)] + ([(tb, jb)] if use_bias else [])
    for t, j in pairs:
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad._value),
                                   atol=GRAD_ATOL, rtol=0)
    if ignore:
        ignored = y == -100
        assert np.all(th.grad.numpy()[ignored] == 0.0)
        if reduction == "none":
            assert np.all(got.detach().numpy()[ignored] == 0.0)


def test_all_ignored_mean_is_zero():
    h, w, _, y, _ = _inputs(20, 16, False)
    loss = PF.fused_linear_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(w),
        torch.full((20,), -100, dtype=torch.int64))
    assert float(loss) == 0.0


def test_flash_ce_flag_takes_the_loop_on_the_cpu():
    """``FLAGS_enable_flash_ce`` is accepted; K9-K11 are not ported, so the
    CPU runs the chunked loop (a CUDA tensor would raise)."""
    h, w, _, y, _ = _inputs(40, 16, False)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y))
    want = PF.fused_linear_cross_entropy(*args)
    with port_flags(enable_flash_ce=True):
        got = PF.fused_linear_cross_entropy(*args)
    assert float(got) == float(want)
