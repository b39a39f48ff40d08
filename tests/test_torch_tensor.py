"""The port's Tensor and autograd: twins of ``tests/test_autograd.py`` (run
on ``paddle_tpu_torch``; where the JAX test reads ``y._grad_node`` the twin
reads ``grad_fn``), the Tensor methods with Paddle's meaning against the
JAX package, the in-place rules, the declared dtypes and the place that
never falls back to the CPU."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.framework.tensor import Tensor as JT

import paddle_tpu_torch as paddle
from tests.torch_port_util import default_place, port_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")


# --------------------------------------------- twins of test_autograd.py ----

def test_simple_backward():
    x = paddle.to_tensor([2.0, 3.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0])


def test_grad_accumulation():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])
    x.clear_grad()
    assert x.grad is None


def test_shared_input_fanout():
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = x * x + x * 3
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [7.0])


def test_stop_gradient_blocks():
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = paddle.to_tensor([3.0], stop_gradient=True)
    z = (x * y).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0])
    assert y.grad is None


def test_detach():
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = x * 2
    d = y.detach()
    assert d.stop_gradient and isinstance(d, paddle.Tensor)
    z = (d * x).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0])


def test_no_grad_context():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.grad_fn is None
    assert y.stop_gradient


def test_no_grad_decorator():
    @paddle.no_grad()
    def f(t):
        return t * 2

    x = paddle.to_tensor([1.0], stop_gradient=False)
    assert f(x).stop_gradient
    assert paddle.is_grad_enabled()
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled()
    assert paddle.is_grad_enabled()


def test_retain_graph():
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [8.0])


def test_double_backward_without_retain_raises():
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_multi_output_op():
    x = paddle.to_tensor(np.arange(6, dtype="float32").reshape(2, 3),
                         stop_gradient=False)
    a, b, c = paddle.split(x, 3, axis=1)
    (a.sum() + (2 * b).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), [[1, 2, 0], [1, 2, 0]])


def test_register_hook_leaf():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    seen = []
    h = x.register_hook(lambda g: seen.append(g.numpy()))
    (x * 3).sum().backward()
    assert len(seen) == 1
    np.testing.assert_allclose(seen[0], [3.0, 3.0])
    h.remove()


def test_register_hook_modifies_grad():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    x.register_hook(lambda g: g * 2)
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])


def test_hook_on_intermediate():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    y.register_hook(lambda g: g * 10)
    (y * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [60.0])


def test_paddle_grad_api():
    x = paddle.to_tensor([3.0], stop_gradient=False)
    y = x * x
    (gx,) = paddle.grad(y, x)
    np.testing.assert_allclose(gx.numpy(), [6.0])
    assert x.grad is None


def test_paddle_grad_intermediate_input():
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = x * 3
    z = y * y
    (gy,) = paddle.grad(z, y)
    np.testing.assert_allclose(gy.numpy(), [12.0])


def test_paddle_grad_unused_raises():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    z = paddle.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    with pytest.raises(ValueError):
        paddle.grad(y, z, retain_graph=True)
    (g,) = paddle.grad(y, [z], allow_unused=True)
    assert g is None


def test_backward_with_grad_tensor():
    x = paddle.to_tensor([1.0, 1.0], stop_gradient=False)
    y = x * 2
    y.backward(paddle.to_tensor([1.0, 5.0]))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 10.0])


def test_non_scalar_backward_seeds_ones_as_jax():
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    x = paddle.to_tensor(xv, stop_gradient=False)
    (x * x).backward()
    jx = jp.to_tensor(xv, stop_gradient=False)
    (jx * jx).backward()
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy())


def test_setitem_autograd():
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    v = paddle.to_tensor([10.0], stop_gradient=False)
    y = x * 1
    y[1] = v
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 0.0, 1.0])
    np.testing.assert_allclose(v.grad.numpy(), [1.0])


def test_getitem_autograd():
    x = paddle.to_tensor(np.arange(9, dtype="float32").reshape(3, 3),
                         stop_gradient=False)
    x[1:, paddle.to_tensor([0, 2])].sum().backward()
    expect = np.zeros((3, 3))
    expect[1:, [0, 2]] = 1
    np.testing.assert_allclose(x.grad.numpy(), expect)


def test_create_graph_and_retain_default():
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = x * x * x
    (g,) = paddle.grad(y, x, create_graph=True)
    assert g.stop_gradient is False
    (g2,) = paddle.grad(g, x)
    np.testing.assert_allclose(g2.numpy(), [12.0])
    # without create_graph the graph is freed
    y = x * x
    paddle.grad(y, x)
    with pytest.raises(RuntimeError):
        paddle.grad(y, x)


# ------------------------------------------------------ Tensor methods ----

X = np.random.RandomState(0).uniform(-1, 1, (2, 3, 4)).astype(np.float32)


def _both(fn):
    got = fn(paddle.to_tensor(X))
    want = fn(jp.to_tensor(X))
    return got, want


@pytest.mark.parametrize("name,fn", [
    ("shape", lambda t: t.shape),
    ("size", lambda t: t.size),
    ("ndim", lambda t: t.ndim),
    ("numel", lambda t: t.numel()),
    ("dim", lambda t: t.dim()),
    ("len", lambda t: len(t)),
])
def test_attributes_take_paddles_meaning(name, fn):
    got, want = _both(fn)
    assert got == want and type(got) is type(want), (name, got, want)


@pytest.mark.parametrize("name,fn", [
    ("transpose", lambda t: t.transpose([2, 0, 1])),
    ("reshape", lambda t: t.reshape([4, -1])),
    ("sum_axis", lambda t: t.sum(axis=1, keepdim=True)),
    ("max", lambda t: t.max(axis=-1)),
    ("min", lambda t: t.min()),
    ("mean", lambda t: t.mean(axis=[0, 2])),
    ("sort", lambda t: t.sort(axis=1)),
    ("split", lambda t: t.split(2, axis=2)[1]),
    ("flatten", lambda t: t.flatten(start_axis=1)),
    ("unsqueeze", lambda t: t.unsqueeze(1)),
    ("expand", lambda t: t.unsqueeze(0).expand([3, 2, 3, 4])),
    ("T", lambda t: t.T),
    ("astype", lambda t: t.astype("float64")),
    ("cast", lambda t: t.cast("int32")),
    ("pow", lambda t: t.pow(2)),
    ("scale", lambda t: t.scale(2.0, bias=1.0)),
    ("matmul", lambda t: t @ t.transpose([0, 2, 1])),
    ("rsub", lambda t: 1.0 - t),
    ("rtruediv", lambda t: 2.0 / (t + 3.0)),
    ("neg_abs", lambda t: abs(-t)),
    ("getitem", lambda t: t[1, :, 1:3]),
    ("getitem_mask", lambda t: t[t > 0]),
    ("add_n", lambda t: t.add_n([t, t])),
    ("argmax", lambda t: t.argmax(axis=1)),
    ("topk", lambda t: t.topk(2)[0]),
])
def test_methods_match_jax(name, fn):
    got, want = _both(fn)
    np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                               np.asarray(want.numpy(), np.float64),
                               rtol=1e-6, atol=1e-6, err_msg=name)


def test_reshape_zero_keeps_the_axis_as_paddle():
    # Paddle's 0 copies the input's size; the JAX package passes it to
    # jnp.reshape, where it means an empty axis (ROADMAP.md C)
    assert paddle.to_tensor(X).reshape([0, -1]).shape == [2, 12]
    with pytest.raises(Exception):
        jp.to_tensor(X).reshape([0, -1])


def test_numpy_item_tolist_float_and_repr():
    t = paddle.to_tensor(X, stop_gradient=False)
    assert isinstance(t.numpy(), np.ndarray)          # detaches, no error
    assert float(t[0, 0, 0]) == pytest.approx(float(X[0, 0, 0]))
    assert t.tolist() == X.tolist()
    assert "Tensor(shape=[2, 3, 4], dtype=float32" in repr(t)
    assert t.place == paddle.CPUPlace()
    assert np.array_equal(np.asarray(t), X)
    b = t.astype("bfloat16")
    assert b.numpy().dtype == np.float32               # no ml_dtypes
    assert isinstance(paddle.to_tensor(X) == 0, paddle.Tensor)
    assert (paddle.to_tensor([1.0]) == None) is False  # noqa: E711


def test_stop_gradient_and_clear_grad():
    x = paddle.to_tensor([1.0, 2.0])
    assert x.stop_gradient and not x.requires_grad
    x.stop_gradient = False
    assert x.requires_grad
    y = (x * 2)
    y.stop_gradient = True                  # a non-leaf: detached in place
    assert y.grad_fn is None
    (x * 3).sum().backward()
    x.clear_grad(set_to_zero=True)
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 0.0])
    x.clear_grad()
    assert x.grad is None


def test_torch_calls_on_a_tensor_give_plain_tensors():
    t = paddle.to_tensor(X)
    out = torch.add(t, t)
    assert type(out) is torch.Tensor and out.shape == torch.Size([2, 3, 4])
    assert isinstance(paddle.add(t, t), paddle.Tensor)


def test_parameter_keeps_torch_names_and_is_a_tensor():
    lin = paddle.nn.Linear(3, 2)
    w = lin.weight
    assert isinstance(w, paddle.Tensor) and isinstance(w, torch.nn.Parameter)
    assert w.shape == torch.Size([3, 2])    # torch's, JAX gives [3, 2] list
    assert not w.stop_gradient and w.trainable and w.persistable
    w.stop_gradient = True
    assert not w.requires_grad
    w.set_value(np.ones((3, 2), np.float32))
    assert float(w.sum()) == 6.0
    assert isinstance(w.numpy(), np.ndarray)


# ----------------------------------------------------------- in place ----

def test_inplace_ops_match_jax_off_the_leaf():
    got = paddle.to_tensor(X)
    want = jp.to_tensor(X)
    for t in (got, want):
        t.add_(t)
        t.scale_(0.5)
        t.clip_(-0.3, 0.3)
        t.exp_()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    z = paddle.to_tensor(X)
    z.zero_()
    assert float(z.abs().sum()) == 0.0
    z.fill_(2.0)
    assert float(z.mean()) == 2.0


def test_inplace_on_a_leaf_that_needs_a_gradient_raises():
    # JAX rebinds the leaf on its tape; the port refuses, as torch does
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="in-place"):
        x.add_(x)
    with pytest.raises(RuntimeError, match="in-place"):
        x[0] = 3.0
    with paddle.no_grad():
        x[0] = 3.0
    assert float(x[0]) == 3.0
    y = x * 1                               # off the leaf: recorded
    y.scale_(2.0)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])


def test_setitem_with_repeated_indices_takes_the_last_as_jax():
    xv = np.zeros((4, 3), np.float32)
    idx = np.array([2, 2, 0])
    vals = np.arange(9, dtype=np.float32).reshape(3, 3)
    got = paddle.to_tensor(xv)
    got[paddle.to_tensor(idx)] = paddle.to_tensor(vals)
    want = jp.to_tensor(xv)
    want[jp.to_tensor(idx)] = jp.to_tensor(vals)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    s = paddle.scatter(paddle.to_tensor(xv), paddle.to_tensor(idx),
                       paddle.to_tensor(vals))
    js = jp.scatter(jp.to_tensor(xv), jp.to_tensor(idx), jp.to_tensor(vals))
    np.testing.assert_array_equal(s.numpy(), js.numpy())


# --------------------------------------------------------- dtypes ----

#: (expression, the JAX package's dtype (x64 off), the port's): the port
#: keeps Paddle's int64 and float64 (ROADMAP.md C)
DTYPES = [
    ("to_tensor([1, 2])", lambda p: p.to_tensor([1, 2]), "int32", "int64"),
    ("to_tensor(np.arange(3))", lambda p: p.to_tensor(np.arange(3)),
     "int32", "int64"),
    ("to_tensor(float64 array)", lambda p: p.to_tensor(np.ones(2)),
     "float32", "float64"),
    ("to_tensor([1.5])", lambda p: p.to_tensor([1.5]), "float32", "float32"),
    ("arange(5)", lambda p: p.arange(5), "int32", "int64"),
    ("argmax", lambda p: p.argmax(p.to_tensor(X)), "int32", "int64"),
    ("topk indices", lambda p: p.topk(p.to_tensor(X), 2)[1], "int32",
     "int64"),
    ("sum of int32", lambda p: p.sum(p.to_tensor(np.arange(3, dtype=
                                                          np.int32))),
     "int32", "int64"),
    ("full(.., 1)", lambda p: p.full([2], 1), "int32", "int64"),
    ("zeros", lambda p: p.zeros([2]), "float32", "float32"),
    ("nonzero", lambda p: p.nonzero(p.to_tensor([0.0, 1.0])), "int32",
     "int64"),
]


def _name(dt):
    s = str(dt)
    return s.replace("torch.", "")


@pytest.mark.parametrize("what,fn,jax_dtype,port_dtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_dtypes_beside_jax(what, fn, jax_dtype, port_dtype):
    assert _name(fn(jp).dtype) == jax_dtype, what
    assert _name(fn(paddle).dtype) == port_dtype, what


# ----------------------------------------------------- no fallback ----

@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_no_fallback():
    with default_place():
        assert paddle.get_device() == "gpu:0"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.zeros([2])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.nn.Linear(2, 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.set_device("gpu")
    assert paddle.get_device() == "cpu:0"
    assert paddle.to_tensor([1.0]).place == paddle.CPUPlace()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_outermost_build_alone_places_a_model():
    """``Layer`` is the one owner of placement: the outermost build's
    ``device`` (None: the current place) is resolved before its constructor
    runs, so a missing card raises before a weight is drawn, and the layers
    built inside never ask for a place of their own."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=31, hidden_size=32, num_layers=2,
                    num_heads=2, max_position_embeddings=16)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with default_place():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GPTForCausalLM(cfg, generator=gen)
        assert torch.equal(gen.get_state(), state)
        model = GPTForCausalLM(cfg, device="cpu", dtype=torch.bfloat16,
                               generator=gen)
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_jax_twin_sanity():
    # the JAX package's own Tensor for the twins above
    assert isinstance(jp.to_tensor([1.0]), JT)
