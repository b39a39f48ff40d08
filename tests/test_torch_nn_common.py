"""The port's dropouts, common functionals and layers
(``paddle_tpu_torch/nn/functional/common.py``, ``norm.py::normalize``,
``nn/layer/common.py``) against the JAX package's on the CPU.

The dropouts' contract (``ROADMAP.md`` C, "Dropout masks"): given one mask,
the JAX package's output and gradient (``_dropout_masked``,
``_alpha_dropout_masked``); JAX's options (``p`` a Tensor, ``p == 1``,
``axis``, ``downscale_in_infer``, ``dropout2d``/``dropout3d``'s ``[N, C]``
masks, ``alpha_dropout``'s ``a`` and ``b``); the keep rule (a share within
five binomial sigmas of ``1 - p``); seeded replay within the port (the
draws are not the JAX package's). Limits: ``FP32_TOL`` of the largest
magnitude, ten times that for gradients.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor as JT
from paddle_tpu.nn.functional import common as jc

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn.functional import common as pc
from tests.torch_port_util import (FP32_TOL, jax_state, port_cpu,  # noqa: F401
                                   sweep_close, twin_check)

pytestmark = pytest.mark.usefixtures("port_cpu")

ALPHA_P = -1.6732632423543772 * 1.0507009873554805


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(shape, p, seed=1):
    return (np.random.RandomState(seed).uniform(0, 1, shape) >= p).astype(
        np.float32)


# ---------------------------------------------------------- dropout ----

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_given_the_mask_matches_jax(p):
    x, m = _x(4, 6), _mask((4, 6), p)
    twin_check(lambda a, b: jc._dropout_masked(a, b, scale=1 / (1 - p)),
               lambda a, b: pc._dropout_masked(a, b, scale=1 / (1 - p)),
               [x, m])


def test_alpha_dropout_given_the_mask_matches_jax():
    p = 0.2
    a = 1.0 / ((1 - p) * (1 + p * ALPHA_P ** 2)) ** 0.5
    b = -a * ALPHA_P * p
    x, m = _x(5, 7), _mask((5, 7), p)
    kw = dict(alpha_p=ALPHA_P, a=a, b=b)
    twin_check(lambda u, v: jc._alpha_dropout_masked(u, v, **kw),
               lambda u, v: pc._alpha_dropout_masked(u, v, **kw), [x, m])


def _drop(p, seed=3, shape=(64, 256), **kw):
    pt.seed(seed)
    x = pt.to_tensor(np.ones(shape, np.float32))
    return PF.dropout(x, p, **kw).numpy()


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_share_scale_and_replay(p):
    y = _drop(p)
    kept = y != 0
    n = y.size
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(kept.sum() - n * (1 - p)) <= 5 * sigma
    np.testing.assert_allclose(y[kept], 1 / (1 - p), rtol=1e-6)
    np.testing.assert_array_equal(y, _drop(p))          # the same seed
    assert not np.array_equal(y, _drop(p, seed=4))


def test_dropout_takes_a_tensor_p_and_p_one():
    x = _x(3, 4)
    pt.seed(5)
    a = PF.dropout(pt.to_tensor(x), pt.to_tensor(np.float32(0.5))).numpy()
    pt.seed(5)
    b = PF.dropout(pt.to_tensor(x), 0.5).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PF.dropout(pt.to_tensor(x), 1.0).numpy(),
                                  JF.dropout(JT(x), 1.0).numpy())


@pytest.mark.parametrize("axis", [0, 1, [0, 2], -1])
def test_dropout_axis_draws_one_mask_over_those_axes(axis):
    y = _drop(0.5, shape=(16, 12, 8), axis=axis)
    axes = {a % 3 for a in ([axis] if isinstance(axis, int) else axis)}
    for ax in set(range(3)) - axes:   # constant along the other axes
        first = np.take(y, [0], axis=ax)
        np.testing.assert_array_equal(y, np.broadcast_to(first, y.shape))
    assert 0 < (y != 0).mean() < 1


@pytest.mark.parametrize("training", [True, False])
def test_downscale_in_infer_matches_jax(training):
    """Unscaled in training (kept values are ``x``), ``x * (1 - p)`` at
    inference: PyTorch's dropout has no such mode."""
    x = _x(32, 32) + 5.0
    kw = dict(training=training, mode="downscale_in_infer")
    got = PF.dropout(pt.to_tensor(x), 0.3, **kw).numpy()
    if training:
        kept = got != 0
        np.testing.assert_array_equal(got[kept], x[kept])
        assert 0.5 < kept.mean() < 0.9
    else:
        want = JF.dropout(JT(x), 0.3, **kw).numpy()
        sweep_close(got, want, FP32_TOL, "downscale_in_infer")
        np.testing.assert_allclose(got, x * 0.7, rtol=1e-6)
    np.testing.assert_array_equal(
        PF.dropout(pt.to_tensor(x), 0.3, training=False).numpy(), x)


@pytest.mark.parametrize("fn,shape,fmt,chan", [
    ("dropout2d", (4, 6, 5, 5), "NCHW", 1),
    ("dropout2d", (4, 5, 5, 6), "NHWC", 3),
    ("dropout3d", (3, 4, 2, 3, 3), "NCDHW", 1),
    ("dropout3d", (3, 2, 3, 3, 4), "NDHWC", 4)])
def test_feature_dropout_masks_whole_maps(fn, shape, fmt, chan):
    pt.seed(6)
    x = pt.to_tensor(np.ones(shape, np.float32))
    y = getattr(PF, fn)(x, 0.5, data_format=fmt).numpy()
    spatial = tuple(a for a in range(1, len(shape)) if a != chan)
    np.testing.assert_array_equal(y.min(spatial), y.max(spatial))
    assert set(np.unique(y)) <= {0.0, 2.0}
    assert 0 < (y != 0).mean() < 1
    np.testing.assert_array_equal(
        getattr(PF, fn)(x, 0.5, training=False).numpy(), x.numpy())


def test_alpha_dropout_keeps_mean_and_variance_and_replays():
    x = np.random.RandomState(7).randn(1 << 16).astype(np.float32)
    outs = []
    for _ in range(2):
        pt.seed(8)
        outs.append(PF.alpha_dropout(pt.to_tensor(x), 0.2).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    y = outs[0].astype(np.float64)
    assert abs(y.mean()) < 0.03 and abs(y.var() - 1.0) < 0.05
    np.testing.assert_array_equal(
        PF.alpha_dropout(pt.to_tensor(x), 0.2, training=False).numpy(), x)


# ---------------------------------------------------- the functionals ----

@pytest.mark.parametrize("ids", [[0, 3, 1, 2], [[1, 4], [-1, 0]]])
def test_one_hot_matches_jax(ids):
    ids = np.array(ids, np.int64)
    got = PF.one_hot(pt.to_tensor(ids), 4)
    want = JF.one_hot(JT(ids), 4).numpy()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_label_smooth_matches_jax():
    y = np.eye(5, dtype=np.float32)[[0, 3, 1]]
    prior = np.random.RandomState(2).dirichlet(np.ones(5)).astype(
        np.float32)[None]
    twin_check(lambda a: JF.label_smooth(a, epsilon=0.2),
               lambda a: PF.label_smooth(a, epsilon=0.2), [y])
    twin_check(lambda a, b: JF.label_smooth(a, b, epsilon=0.3),
               lambda a, b: PF.label_smooth(a, b, epsilon=0.3), [y, prior],
               diff=(0, 1))


@pytest.mark.parametrize("axis,eps", [(1, 1e-8), (0, 1e-8), (-1, 0.5)])
def test_cosine_similarity_matches_jax(axis, eps):
    twin_check(lambda a, b: JF.cosine_similarity(a, b, axis, eps),
               lambda a, b: PF.cosine_similarity(a, b, axis, eps),
               [_x(3, 4, seed=1), _x(3, 4, seed=2) * 0.1], diff=(0, 1))


@pytest.mark.parametrize("bias", [True, False])
def test_bilinear_matches_jax(bias):
    arrays = [_x(3, 4, seed=1), _x(3, 5, seed=2), _x(2, 4, 5, seed=3)]
    if bias:
        arrays.append(_x(2, seed=4))
    twin_check(JF.bilinear, PF.bilinear, arrays,
               diff=tuple(range(len(arrays))))


@pytest.mark.parametrize("offset,dim1,dim2", [(0, -2, -1), (1, 0, 2),
                                              (-2, 2, 0)])
def test_diag_embed_matches_jax(offset, dim1, dim2):
    twin_check(lambda a: JF.diag_embed(a, offset, dim1, dim2),
               lambda a: PF.diag_embed(a, offset, dim1, dim2), [_x(2, 3)])


@pytest.mark.parametrize("p,axis", [(2, 1), (1, -1), (3, 0)])
def test_normalize_matches_jax(p, axis):
    twin_check(lambda a: JF.normalize(a, p, axis),
               lambda a: PF.normalize(a, p, axis), [_x(3, 4, 2)])


# ------------------------------------------------------------ layers ----

@pytest.mark.parametrize("padding_idx", [None, 2, -1])
def test_embedding_layer_matches_jax(padding_idx):
    jl = jnn.Embedding(7, 4, padding_idx=padding_idx)
    tl = pnn.Embedding(7, 4, padding_idx=padding_idx)
    assert [(n, tuple(p.shape)) for n, p in tl.named_parameters()] == [
        ("weight", (7, 4))]
    if padding_idx is not None:
        assert not tl.weight.detach()[padding_idx].any()
    load_jax_state(tl, jax_state(jl))
    ids = np.array([[0, 2, 6], [6, 1, 2]], np.int64)
    got = tl(pt.to_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), jl(JT(ids)).numpy())
    got.sum().backward()
    rows = np.bincount(ids.ravel(), minlength=7).astype(np.float32)
    if padding_idx is not None:
        rows[padding_idx % 7] = 0
    np.testing.assert_array_equal(tl.weight.grad.numpy()[:, 0], rows)


@pytest.mark.parametrize("bias_attr", [None, False])
def test_bilinear_layer_matches_jax(bias_attr):
    jl = jnn.Bilinear(4, 5, 3, bias_attr=bias_attr)
    tl = pnn.Bilinear(4, 5, 3, bias_attr=bias_attr)
    names = [(n, tuple(p.shape)) for n, p in tl.named_parameters()]
    assert names == [(n, tuple(p.shape)) for n, p in jl.named_parameters()]
    bound = 1 / 2.0
    assert float(tl.weight.detach().abs().max()) <= bound
    load_jax_state(tl, jax_state(jl))
    twin_check(jl, tl, [_x(6, 4, seed=1), _x(6, 5, seed=2)], diff=(0, 1))


def test_prelu_layer_loads_the_jax_slopes():
    jl = jnn.PReLU(3, init=0.3)
    jl.weight.set_value(np.array([0.1, 0.2, 0.4], np.float32))
    tl = pnn.PReLU(3)
    load_jax_state(tl, jax_state(jl))
    twin_check(jl, tl, [_x(2, 3, 4, 4)])


@pytest.mark.parametrize("cls,args", [
    ("Dropout", (0.5,)), ("Dropout", (0.5, 1)),
    ("Dropout", (0.3, None, "downscale_in_infer")), ("Dropout2D", (0.5,)),
    ("Dropout3D", (0.5,)), ("AlphaDropout", (0.5,))])
def test_dropout_layers_drop_in_training_only(cls, args):
    x = _x(2, 3, 4, 4, 2) if cls == "Dropout3D" else _x(4, 3, 4, 4)
    jl, tl = getattr(jnn, cls)(*args), getattr(pnn, cls)(*args)
    assert tl.parameters() == []
    for layer in (jl, tl):
        layer.eval()
    twin_check(jl, tl, [x])
    tl.train()
    pt.seed(9)
    y = tl(pt.to_tensor(x)).numpy()
    assert not np.allclose(y, x)
    pt.seed(9)
    np.testing.assert_array_equal(tl(pt.to_tensor(x)).numpy(), y)


@pytest.mark.parametrize("start,stop", [(1, -1), (0, 1), (2, 3)])
def test_flatten_and_identity_match_jax(start, stop):
    x = _x(2, 3, 4, 5)
    twin_check(jnn.Flatten(start, stop), pnn.Flatten(start, stop), [x])
    twin_check(jnn.Identity(3, k=1), pnn.Identity(3, k=1), [x])


@pytest.mark.parametrize("p,keepdim", [(2.0, False), (1.0, True),
                                       (3.0, False)])
def test_pairwise_distance_and_cosine_similarity_layers_match_jax(p, keepdim):
    a, b = _x(4, 6, seed=1), _x(4, 6, seed=2)
    twin_check(jnn.PairwiseDistance(p, keepdim=keepdim),
               pnn.PairwiseDistance(p, keepdim=keepdim), [a, b],
               diff=(0, 1))
    twin_check(jnn.CosineSimilarity(axis=0), pnn.CosineSimilarity(axis=0),
               [a, b], diff=(0, 1))


# --------------------------------------------------------------- amp ----

def _dt(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_gives_jaxs_dtypes(level):
    x, y = _x(3, 4, seed=1), _x(3, 4, seed=2)
    w, m = _x(2, 4, 4, seed=3), _mask((3, 4), 0.5)
    cases = [
        ("cosine_similarity", lambda F, T: F.cosine_similarity(T(x), T(y))),
        ("bilinear", lambda F, T: F.bilinear(T(x), T(y), T(w))),
        ("label_smooth", lambda F, T: F.label_smooth(T(x))),
        ("normalize", lambda F, T: F.normalize(T(x))),
        ("diag_embed", lambda F, T: F.diag_embed(T(x))),
        ("dropout_masked", lambda F, T: F.common._dropout_masked(
            T(x), T(m), scale=2.0)),
    ]
    for src in ("float32", "bfloat16"):
        def jt(a):
            return JT(a).astype(src)

        def tt(a):
            return pt.to_tensor(a).astype(src)

        for name, fn in cases:
            with jp.amp.auto_cast(level=level, dtype="bfloat16"):
                want = _dt(fn(JF, jt))
            with pt.amp.auto_cast(level=level, dtype="bfloat16"):
                got = _dt(fn(PF, tt))
            assert got == want, (name, src, level)
