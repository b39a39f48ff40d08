"""LayerNorm of the port (kernel K7's and K8's wrappers and the router)
against the JAX package's Pallas ``fused_layer_norm`` in interpret mode and
its ``jax.grad``, on the CPU.

Tolerances: fp32 outputs and dx agree to 1e-5 (same fp32 arithmetic, other
reduction order); dgamma and dbeta are fp32 sums over every row, held to
1e-5 relative to their largest entry. With bf16 x both sides compute in
fp32 and round once to bf16, so they agree to one bf16 step:
|Δ| <= 2^-7 · max(1, |y|).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import interpret_mode
from paddle_tpu.ops.pallas.layer_norm import fused_layer_norm

from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.cuda import layer_norm as k7
from tests.torch_port_util import FP32_TOL, no_persistent_compile_cache  # noqa: F401

BF16_STEP = 2.0 ** -7


def _inputs(rows, feat, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, feat) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(feat)).astype(np.float32)
    b = (0.1 * rng.randn(feat)).astype(np.float32)
    return x, g, b


def _close_bf16(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.all(np.abs(got - want)
                  <= BF16_STEP * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("rows", [5, 13, 3 * 7])
def test_kernel_wrapper_fp32_matches_pallas(rows, no_persistent_compile_cache):
    x, g, b = _inputs(rows, 256)
    with interpret_mode():
        want = np.asarray(fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(b), eps=1e-5))
    got = k7.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("rows", [5, 13])
def test_kernel_wrapper_bf16_x_fp32_gamma(rows, no_persistent_compile_cache):
    x, g, b = _inputs(rows, 256, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with interpret_mode():
        want = fused_layer_norm(xb, jnp.asarray(g), jnp.asarray(b))
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = k7.layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_leading_dims_flatten_like_jax(no_persistent_compile_cache):
    x, g, b = _inputs(2 * 3 * 5, 128, seed=2)
    x3 = x.reshape(2, 3 * 5, 128)
    with interpret_mode():
        want = np.asarray(fused_layer_norm(jnp.asarray(x3), jnp.asarray(g),
                                           jnp.asarray(b)))
    got = k7.layer_norm(torch.from_numpy(x3), torch.from_numpy(g),
                        torch.from_numpy(b))
    assert tuple(got.shape) == (2, 15, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("feat", [256, 100])
def test_router_matches_jax_layer_norm(feat, no_persistent_compile_cache):
    """The router sends a 128-multiple width to K7's wrapper and any other
    width to the plain expression — both agree with the JAX router."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF

    x, g, b = _inputs(7, feat, seed=3)
    with interpret_mode():
        want = JF.layer_norm(paddle.to_tensor(x), [feat],
                             paddle.to_tensor(g), paddle.to_tensor(b))
    calls = k7.layer_norm.launches
    got = PF.layer_norm(torch.from_numpy(x), [feat], torch.from_numpy(g),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=FP32_TOL, rtol=0)
    assert k7.layer_norm.launches == calls  # the CPU launches no kernel


def _jax_grads(x, g, b, dy):
    """``(dx, dgamma, dbeta)`` of the Pallas LayerNorm (K8 interpreted)."""
    def f(x, g, b):
        return jnp.vdot(fused_layer_norm(x, g, b, eps=1e-5).astype(
            jnp.float32), dy)

    with interpret_mode():
        return jax.grad(f, (0, 1, 2))(x, jnp.asarray(g), jnp.asarray(b))


def _close_sums(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("rows", [300, 7])   # not multiples of 256
def test_k8_plain_matches_pallas_grads_fp32(rows, no_persistent_compile_cache):
    x, g, b = _inputs(rows, 256, seed=4)
    dy = np.random.RandomState(5).randn(rows, 256).astype(np.float32)
    want = _jax_grads(jnp.asarray(x), g, b, jnp.asarray(dy))
    got = k7.layer_norm_bwd(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(dy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=FP32_TOL, rtol=0)
    _close_sums(got[1].numpy(), want[1])
    _close_sums(got[2].numpy(), want[2])


def test_k8_plain_bf16_x_fp32_gamma(no_persistent_compile_cache):
    """bf16 x and dy with fp32 gamma: dx comes back bf16, dgamma and dbeta
    fp32 (gamma's dtype), as the Pallas custom vjp casts them."""
    x, g, b = _inputs(300, 128, seed=6)
    dy = np.random.RandomState(7).randn(300, 128).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    dyb = jnp.asarray(dy).astype(jnp.bfloat16)
    want = _jax_grads(xb, g, b, dyb.astype(jnp.float32))
    assert want[0].dtype == jnp.bfloat16 and want[1].dtype == jnp.float32
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    dyt = torch.from_numpy(np.array(dyb.astype(jnp.float32))).bfloat16()
    dx, dgamma, dbeta = k7.layer_norm_bwd(xt, torch.from_numpy(g), dyt)
    assert dx.dtype == torch.bfloat16 and dgamma.dtype == torch.float32
    _close_bf16(dx.float().numpy(), np.asarray(want[0].astype(jnp.float32)))
    _close_sums(dgamma.numpy(), want[1])
    _close_sums(dbeta.numpy(), want[2])


def test_module_backward_runs_through_the_k8_wrapper(
        monkeypatch, no_persistent_compile_cache):
    """``LayerNorm`` under autograd saves x and gamma and differentiates
    through ``layer_norm_bwd`` (K8's plain version on the CPU), giving the
    Pallas custom vjp's gradients."""
    x, g, b = _inputs(13, 256, seed=8)
    dy = np.random.RandomState(9).randn(13, 256).astype(np.float32)
    calls = []
    real = k7.layer_norm_bwd
    monkeypatch.setattr(k7, "layer_norm_bwd",
                        lambda *a: calls.append(1) or real(*a))
    ln = LayerNorm(256)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(g))
        ln.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_()
    got = torch.autograd.grad(ln(xt), (xt, ln.weight, ln.bias),
                              torch.from_numpy(dy))
    assert calls == [1]
    want = _jax_grads(jnp.asarray(x), g, b, jnp.asarray(dy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=FP32_TOL, rtol=0)
    _close_sums(got[1].numpy(), want[1])
    _close_sums(got[2].numpy(), want[2])


def test_router_gate_mirrors_pallas_gate():
    from paddle_tpu.ops.pallas.layer_norm import supports

    for feat in (64, 100, 128, 256, 768, 1000):
        assert k7.supports(feat) == supports(feat)


def test_layer_norm_module_defaults():
    ln = LayerNorm(256)
    assert torch.equal(ln.weight, torch.ones(256))
    assert torch.equal(ln.bias, torch.zeros(256))
    x = torch.randn(3, 256)
    want = k7.layer_norm_plain(x, ln.weight, ln.bias)
    torch.testing.assert_close(ln(x).detach(), want.detach(), atol=0, rtol=0)


def test_wrapper_refuses_a_non_cuda_device():
    """Off the CPU the wrapper launches its kernel or raises — it never
    runs the plain version (a meta tensor stands in for a non-CPU one)."""
    x = torch.empty(4, 256, device="meta")
    g = torch.empty(256, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k7.layer_norm(x, g, g)
