"""The port's activation functionals and layers
(``paddle_tpu_torch/nn/functional/activation.py``, ``nn/layer/activation.py``)
against the JAX package's on the CPU, on seeded numpy inputs: forward and
gradient of every functional across its options (the JAX defaults and the
options where PyTorch's function of the same name differs), the in-place
forms, every layer, the random activations' contract (given the same
slopes or noise, JAX's output; seeded replay within the port) and the
dtypes ``amp.auto_cast`` gives at O1 and O2.

Limits: ``FP32_TOL`` (1e-5) of the largest magnitude for outputs, ten
times that for gradients (``tests/torch_port_util.py::twin_check``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor as JT

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from tests.torch_port_util import (FP32_TOL, jax_state, port_cpu,  # noqa: F401
                                   sweep_close, twin_check)

pytestmark = pytest.mark.usefixtures("port_cpu")


def _x(*shape, seed=0, lo=-3.0, hi=3.0):
    """Uniform in ``[lo, hi)``, kept off 0 and the kinks at +-0.5, +-1, +-3,
    +-6 (where JAX's and PyTorch's one-sided gradients may differ)."""
    v = np.random.RandomState(seed).uniform(lo, hi, shape)
    for k in (0.0, 0.5, 1.0, 3.0, 6.0):
        for s in (k, -k):
            near = np.abs(v - s) < 1e-2
            v[near] += 2e-2
    return v.astype(np.float32)


#: (functional, keyword options, input range): every activation, its JAX
#: defaults and its other options
CASES = [
    ("sigmoid", {}, 4), ("tanh", {}, 4), ("silu", {}, 4), ("swish", {}, 4),
    ("relu6", {}, 8), ("elu", {}, 3), ("elu", {"alpha": 0.3}, 3),
    ("selu", {}, 3), ("selu", {"scale": 1.3, "alpha": 2.0}, 3),
    ("celu", {}, 3), ("celu", {"alpha": 0.4}, 3),
    ("softplus", {}, 3), ("softplus", {"beta": 3.0, "threshold": 2.0}, 3),
    ("softsign", {}, 3), ("softshrink", {}, 2),
    ("softshrink", {"threshold": 1.0}, 2), ("hardshrink", {}, 2),
    ("hardshrink", {"threshold": 1.0}, 2), ("hardtanh", {}, 2),
    ("hardtanh", {"min": -0.5, "max": 1.0}, 2), ("hardswish", {}, 8),
    ("hardsigmoid", {}, 8), ("hardsigmoid", {"slope": 0.2, "offset": 0.3}, 8),
    ("leaky_relu", {}, 3), ("leaky_relu", {"negative_slope": 0.3}, 3),
    ("log_sigmoid", {}, 4), ("log_softmax", {}, 4),
    ("log_softmax", {"axis": 0}, 4), ("mish", {}, 4), ("tanhshrink", {}, 3),
    ("thresholded_relu", {}, 3),
    ("thresholded_relu", {"threshold": 0.5, "value": -1.0}, 3),
    ("glu", {}, 3), ("glu", {"axis": 0}, 3), ("gelu", {}, 3),
    ("gelu", {"approximate": True}, 3), ("relu", {}, 3), ("softmax", {}, 3),
    ("rrelu", {}, 3), ("rrelu", {"lower": 0.05, "upper": 0.5}, 3),
]


@pytest.mark.parametrize("name,kw,r", CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'default'}"
                              for n, k, _ in CASES])
def test_functional_matches_jax(name, kw, r):
    x = _x(4, 6, seed=len(name), lo=-r, hi=r)
    twin_check(lambda t: getattr(JF, name)(t, **kw),
               lambda t: getattr(PF, name)(t, **kw), [x])


@pytest.mark.parametrize("kw", [{}, {"slope": 0.2, "offset": 0.3}])
def test_hardsigmoid_is_not_torchs(kw):
    """The JAX formula ``clip(slope x + offset, 0, 1)``, with JAX's default
    slope 0.1666667: torch's hardsigmoid (exactly 1/6, no options) fails the
    non-default case."""
    x = _x(64, lo=-8, hi=8)
    want = np.clip(kw.get("slope", 0.1666667) * x.astype(np.float64)
                   + kw.get("offset", 0.5), 0, 1)
    got = PF.hardsigmoid(pt.to_tensor(x), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    torchs = torch.nn.functional.hardsigmoid(torch.from_numpy(x)).numpy()
    assert (np.abs(torchs - want).max() > 0.05) == bool(kw)


def test_softplus_switches_to_x_past_the_threshold():
    x = np.array([-2.0, 0.1, 0.6, 1.5, 30.0], np.float32)
    got = PF.softplus(pt.to_tensor(x), beta=2.0, threshold=1.0).numpy()
    want = JF.softplus(JT(x), beta=2.0, threshold=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got[2:], x[2:])    # beta * x > 1


@pytest.mark.parametrize("shape,fmt,wshape", [
    ((2, 3, 4, 5), "NCHW", (3,)), ((2, 4, 5, 3), "NHWC", (3,)),
    ((2, 3, 4, 5), "NCHW", (1,)), ((4, 6), "NCHW", (6,))])
def test_prelu_matches_jax(shape, fmt, wshape):
    x = _x(*shape, seed=3)
    w = np.random.RandomState(4).uniform(0.1, 0.5, wshape).astype(np.float32)
    twin_check(lambda a, b: JF.prelu(a, b, data_format=fmt),
               lambda a, b: PF.prelu(a, b, data_format=fmt), [x, w],
               diff=(0, 1))


@pytest.mark.parametrize("groups,axis,shape", [(2, 1, (2, 6, 3, 3)),
                                               (3, 1, (2, 6, 3, 3)),
                                               (2, 3, (2, 3, 3, 4))])
def test_maxout_matches_jax(groups, axis, shape):
    n = int(np.prod(shape))
    x = (np.random.RandomState(5).permutation(n) / n).reshape(shape)
    twin_check(lambda t: JF.maxout(t, groups, axis),
               lambda t: PF.maxout(t, groups, axis), [x.astype(np.float32)])


def test_maxout_takes_a_negative_axis():
    """``axis=-1`` is the last axis here; the JAX package's reshape fails
    there (ROADMAP.md C)."""
    x = _x(2, 3, 3, 4)
    got = PF.maxout(pt.to_tensor(x), 2, axis=-1).numpy()
    want = PF.maxout(pt.to_tensor(x), 2, axis=3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,jfn", [
    ("tanh_", JF.tanh_), ("relu_", JF.relu_), ("elu_", JF.elu_),
    ("softmax_", JF.softmax_)])
def test_inplace_forms_write_the_input(name, jfn):
    x = _x(3, 5)
    t = pt.to_tensor(x)
    out = getattr(PF, name)(t)
    assert out is t
    sweep_close(t.numpy(), jfn(JT(x)).numpy(), FP32_TOL, name)
    leaf = pt.to_tensor(x, stop_gradient=False)
    with pytest.raises(RuntimeError, match="in-place"):
        getattr(PF, name)(leaf)


# ----------------------------------------------------------- random ----

def test_rrelu_given_the_slopes_matches_jax_and_replays():
    from paddle_tpu.nn.functional import activation as ja

    from paddle_tpu_torch.nn.functional import activation as pa

    x = _x(4, 8, seed=6)
    a = np.random.RandomState(7).uniform(0.1, 0.3, x.shape).astype(np.float32)
    twin_check(ja._prelu_like, pa._prelu_like, [x, a], diff=(0, 1))
    outs = []
    for _ in range(2):
        pt.seed(11)
        outs.append(PF.rrelu(pt.to_tensor(x), 0.1, 0.3, training=True)
                    .numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    neg = x < 0
    slopes = outs[0][neg] / x[neg]
    assert slopes.min() >= 0.1 - 1e-6 and slopes.max() <= 0.3 + 1e-6
    assert slopes.std() > 0.03          # one slope an element
    np.testing.assert_array_equal(outs[0][~neg], x[~neg])
    ev = PF.rrelu(pt.to_tensor(x), 0.1, 0.3, training=False).numpy()
    np.testing.assert_allclose(ev, np.where(x >= 0, x, 0.2 * x), rtol=1e-6)


def test_gumbel_softmax_given_the_noise_matches_jax_and_replays():
    from paddle_tpu.nn.functional import activation as ja

    from paddle_tpu_torch.nn.functional import activation as pa

    x = _x(4, 6, seed=8)
    g = np.random.RandomState(9).gumbel(size=x.shape).astype(np.float32)
    twin_check(lambda a, b: ja._gumbel_softmax_raw(a, b, temperature=0.7,
                                                   axis=-1),
               lambda a, b: pa._gumbel_softmax_raw(a, b, temperature=0.7,
                                                   axis=-1), [x, g])
    outs = []
    for _ in range(2):
        pt.seed(12)
        outs.append(PF.gumbel_softmax(pt.to_tensor(x), 0.5).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].sum(-1), 1.0, rtol=1e-5)


def test_hard_gumbel_softmax_is_one_hot_with_the_soft_gradient():
    """Straight-through: the forward is the one-hot of the soft sample's
    argmax, the gradient the soft sample's."""
    x = pt.to_tensor(_x(5, 7, seed=10), stop_gradient=False)
    c = torch.from_numpy(np.random.RandomState(1).randn(5, 7)
                         .astype(np.float32))
    pt.seed(13)
    hard = PF.gumbel_softmax(x, 0.5, hard=True)
    pt.seed(13)
    soft = PF.gumbel_softmax(x, 0.5)
    h = hard.numpy()
    assert set(np.unique(h)) == {0.0, 1.0}
    np.testing.assert_array_equal(h.argmax(-1), soft.numpy().argmax(-1))
    (gh,) = pt.grad((hard * c).sum(), [x], retain_graph=True)
    (gs,) = pt.grad((soft * c).sum(), [x])
    np.testing.assert_allclose(gh.numpy(), gs.numpy(), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ layers ----

#: (layer, constructor arguments): every activation layer
LAYERS = [
    ("CELU", (0.5,)), ("ELU", (0.7,)), ("GELU", (True,)), ("GLU", (1,)),
    ("Hardshrink", (0.7,)), ("Hardsigmoid", ()), ("Hardswish", ()),
    ("Hardtanh", (-0.5, 2.0)), ("LeakyReLU", (0.2,)), ("LogSigmoid", ()),
    ("LogSoftmax", (0,)), ("Maxout", (2,)), ("Mish", ()), ("PReLU", (4,)),
    ("RReLU", (0.1, 0.2)), ("ReLU", ()), ("ReLU6", ()), ("SELU", ()),
    ("Sigmoid", ()), ("Silu", ()), ("Softmax", (1,)), ("Softmax2D", ()),
    ("Softplus", (2.0, 1.0)), ("Softshrink", (0.3,)), ("Softsign", ()),
    ("Swish", ()), ("Tanh", ()), ("Tanhshrink", ()),
    ("ThresholdedReLU", (0.4, -0.2)),
]


@pytest.mark.parametrize("name,args", LAYERS, ids=[n for n, _ in LAYERS])
def test_layer_matches_jax(name, args):
    jl = getattr(jnn, name)(*args)
    tl = getattr(pnn, name)(*args)
    jl.eval()
    tl.eval()
    tl.set_state_dict(jax_state(jl))
    assert [(n, tuple(p.shape)) for n, p in tl.named_parameters()] == [
        (n, tuple(p.shape)) for n, p in jl.named_parameters()]
    x = _x(2, 4, 3, 4, seed=2)
    twin_check(jl, tl, [x])
    plain = tl(torch.from_numpy(x))             # plain in, plain out
    assert type(plain) is torch.Tensor


def test_prelu_layer_holds_its_slopes():
    jl, tl = jnn.PReLU(3, init=0.1), pnn.PReLU(3, init=0.1)
    assert [n for n, _ in tl.named_parameters()] == ["weight"]
    np.testing.assert_array_equal(tl.weight.numpy(), jl.weight.numpy())
    x = _x(2, 3, 2, 2)
    (g,) = pt.grad(tl(pt.to_tensor(x)).sum(), [tl.weight])
    np.testing.assert_allclose(g.numpy(), np.minimum(x, 0).sum((0, 2, 3)),
                               rtol=1e-5)


def test_rrelu_layer_draws_in_training_only():
    layer = pnn.RReLU(0.1, 0.3)
    x = pt.to_tensor(-np.ones((4, 64), np.float32))
    layer.train()
    y = layer(x).numpy()
    assert len(np.unique(y)) > 10 and y.min() >= -0.3 and y.max() <= -0.1
    layer.eval()
    np.testing.assert_allclose(layer(x).numpy(), -0.2, rtol=1e-6)


def test_softmax2d_refuses_other_ranks():
    with pytest.raises(ValueError, match="3-D or 4-D"):
        pnn.Softmax2D()(pt.to_tensor(np.ones((2, 3), np.float32)))


# --------------------------------------------------------------- amp ----

AMP_FNS = ["sigmoid", "tanh", "silu", "relu6", "elu", "selu", "celu",
           "softplus", "softsign", "softshrink", "hardshrink", "hardtanh",
           "hardswish", "hardsigmoid", "leaky_relu", "log_sigmoid",
           "log_softmax", "mish", "tanhshrink", "thresholded_relu", "glu",
           "rrelu"]


def _dt(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_gives_jaxs_dtypes(level):
    x = _x(4, 6)
    for src in ("float32", "bfloat16"):
        jx, tx = JT(x).astype(src), pt.to_tensor(x).astype(src)
        for name in AMP_FNS:
            with jp.amp.auto_cast(level=level, dtype="bfloat16"):
                want = _dt(getattr(JF, name)(jx))
            with pt.amp.auto_cast(level=level, dtype="bfloat16"):
                got = _dt(getattr(PF, name)(tx))
            assert got == want, (name, src, level)
        with jp.amp.auto_cast(level=level, dtype="bfloat16"):
            want = _dt(JF.prelu(jx, JT(np.ones(1, np.float32))))
        with pt.amp.auto_cast(level=level, dtype="bfloat16"):
            got = _dt(PF.prelu(tx, pt.to_tensor(np.ones(1, np.float32))))
        assert got == want, ("prelu", src, level)
    # the black list keeps log_softmax in fp32 at both levels
    with pt.amp.auto_cast(level=level, dtype="bfloat16"):
        assert _dt(PF.log_softmax(pt.to_tensor(x).astype("bfloat16"))) == \
            "float32"
