"""The port's PyLayer and double backward: twins of
``tests/test_py_layer_double_backward.py`` on ``paddle_tpu_torch`` (the JAX
test's jitted step has no counterpart: the port has no ``jit``, ROADMAP.md
A10), and the context's ``mark_non_differentiable`` and
``set_materialize_grads``."""
import numpy as np
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu_torch.autograd import PyLayer
from tests.torch_port_util import port_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")


def T(a, stop_gradient=True):
    return paddle.to_tensor(np.asarray(a, np.float32),
                            stop_gradient=stop_gradient)


class _Scale(PyLayer):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return x * alpha

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensor()
        return dy * ctx.alpha


class _TanhTwice(PyLayer):
    @staticmethod
    def forward(ctx, a, b):
        ya, yb = paddle.tanh(a), paddle.tanh(b)
        ctx.save_for_backward(ya, yb)
        return ya, yb

    @staticmethod
    def backward(ctx, dya, dyb):
        ya, yb = ctx.saved_tensor()
        return dya * (1 - ya * ya), dyb * (1 - yb * yb)


def test_pylayer_roundtrip_simple():
    x = T([1.0, -2.0, 3.0], False)
    y = _Scale.apply(x, 2.5)
    assert isinstance(y, paddle.Tensor)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2.5, atol=1e-6)


def test_pylayer_matches_builtin_grad():
    xv = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    x1 = T(xv, False)
    a1, b1 = _TanhTwice.apply(x1 * 2.0, x1 + 1.0)
    (a1.sum() + (b1 * b1).sum()).backward()
    x2 = T(xv, False)
    a2, b2 = paddle.tanh(x2 * 2.0), paddle.tanh(x2 + 1.0)
    (a2.sum() + (b2 * b2).sum()).backward()
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), atol=1e-5)


def test_pylayer_none_grad_and_non_tensor_args():
    class PickFirst(PyLayer):
        @staticmethod
        def forward(ctx, a, b, k):
            return a * k + b.detach()

        @staticmethod
        def backward(ctx, dy):
            return dy * 3.0, None

    a = T(np.ones(2), False)
    b = T(np.ones(2), False)
    out = PickFirst.apply(a, b, 3.0)
    out.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), 3.0)
    assert b.grad is None


def test_double_backward_scalar_chain():
    x = T([2.0], False)
    y = x * x * x
    (g,) = paddle.grad(y, x, create_graph=True)
    np.testing.assert_allclose(g.numpy(), [12.0], rtol=1e-5)
    assert g.stop_gradient is False
    (g2,) = paddle.grad(g, x)
    np.testing.assert_allclose(g2.numpy(), [12.0], rtol=1e-5)


def test_gradient_penalty_training():
    paddle.seed(0)
    lin1 = paddle.nn.Linear(3, 8)
    lin2 = paddle.nn.Linear(8, 1)
    params = lin1.parameters() + lin2.parameters()
    opt = paddle.optimizer.SGD(learning_rate=0.05, parameters=params)
    xv = np.random.RandomState(0).randn(16, 3).astype(np.float32)

    def penalty_value():
        x = T(xv, False)
        score = lin2(paddle.tanh(lin1(x))).sum()
        (gx,) = paddle.grad(score, x, create_graph=True)
        norm = (gx * gx).sum(axis=1).sqrt()
        return ((norm - 1.0) ** 2).mean()

    p0 = float(penalty_value())
    for _ in range(20):
        pen = penalty_value()
        pen.backward()
        opt.step()
        opt.clear_grad()
    p1 = float(penalty_value())
    assert p1 < p0, f"gradient penalty did not decrease: {p0} -> {p1}"
    assert all(np.isfinite(p.numpy()).all() for p in params)


def test_double_backward_through_pylayer():
    class Square(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 2.0 * x

    x = T([3.0], False)
    y = Square.apply(x)
    (g,) = paddle.grad(y, x, create_graph=True)
    np.testing.assert_allclose(g.numpy(), [6.0], rtol=1e-6)
    (g2,) = paddle.grad(g, x)
    np.testing.assert_allclose(g2.numpy(), [2.0], rtol=1e-6)


def test_pylayer_matches_the_jax_package():
    import paddle_tpu as jp
    from paddle_tpu.autograd import PyLayer as JPyLayer

    def make(base, lib):
        class Cube(base):
            @staticmethod
            def forward(ctx, x, k):
                ctx.save_for_backward(x)
                ctx.k = k
                return x * x * x * k

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                return dy * 3.0 * x * x * ctx.k

        return Cube

    xv = np.random.RandomState(3).randn(5).astype(np.float32)
    got = []
    for lib, base in ((paddle, PyLayer), (jp, JPyLayer)):
        x = lib.to_tensor(xv, stop_gradient=False)
        y = make(base, lib).apply(x, 0.5)
        (g,) = lib.grad(y.sum(), x, create_graph=True)
        (g2,) = lib.grad(g.sum(), x)
        got.append((y.numpy(), g.numpy(), g2.numpy()))
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_mark_non_differentiable_and_materialize_grads():
    class SortIdx(PyLayer):
        @staticmethod
        def forward(ctx, x):
            idx = paddle.argsort(x)
            y = x * 2.0
            ctx.mark_non_differentiable(idx)
            return y, idx

        @staticmethod
        def backward(ctx, dy, didx):
            return dy * 2.0

    x = T([3.0, 1.0, 2.0], False)
    y, idx = SortIdx.apply(x)
    assert idx.stop_gradient and not y.stop_gradient
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0, 2.0])

    class Two(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.set_materialize_grads(False)
            return x * 1.0, x * 2.0

        @staticmethod
        def backward(ctx, da, db):
            assert db is None          # not materialized as zeros
            return da

    x = T([1.0], False)
    a, _ = Two.apply(x)
    a.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0])
