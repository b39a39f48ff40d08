"""The port's CTC, hierarchical-sigmoid and margin cross-entropy losses and
their layers, ``class_center_sample``, ``sequence_mask``,
``sparse_attention`` and the ``amp`` dtypes of the slice's ops
(``paddle_tpu_torch/nn/functional/loss.py``, ``common.py``,
``sequence.py``, ``sparse_attention.py``) against the JAX package's on the
CPU.

Limits: ``FP32_TOL`` (1e-5) of the largest JAX magnitude for outputs, ten
times that for gradients (``twin_check``). ``class_center_sample`` has the
random layers' contract (``ROADMAP.md`` C): given the same draw, JAX's
result; every positive class kept; seeded replay within the port.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor as JT
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn.functional import common as pc
from tests.torch_port_util import (FP32_TOL, jax_state, port_cpu,  # noqa: F401
                                   sweep_close, twin_check)

pytestmark = pytest.mark.usefixtures("port_cpu")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ctc_inputs(seed=0, t=20, b=3, c=6, s=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(t, b, c).astype(np.float32)
    labels = rng.randint(1, c, (b, s)).astype(np.int64)
    ilen = np.array([t, t - 3, t - 7][:b], np.int64)
    llen = np.array([s, s - 2, 1][:b], np.int64)
    return logits, labels, ilen, llen


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("blank", [0, 5])
def test_ctc_loss_matches_jax(reduction, blank):
    logits, labels, ilen, llen = _ctc_inputs()
    if blank == 5:
        labels = labels - 1                   # classes 0-4, blank last
    twin_check(lambda a, y, i, n: JF.ctc_loss(a, y, i, n, blank, reduction),
               lambda a, y, i, n: PF.ctc_loss(a, y, i, n, blank, reduction),
               [logits, labels, ilen, llen])
    jl, tl = jnn.CTCLoss(blank, reduction), pnn.CTCLoss(blank, reduction)
    twin_check(jl, tl, [logits, labels, ilen, llen])


def test_ctc_norm_by_times_scales_the_gradient_as_paddle():
    """Declared: ``norm_by_times`` divides each sequence's gradient by its
    input length (Paddle's warpctc); the loss is unchanged. The JAX
    package drops the flag."""
    logits, labels, ilen, llen = _ctc_inputs(1)
    grads = []
    for flag in (False, True):
        x = pt.to_tensor(logits, stop_gradient=False)
        loss = PF.ctc_loss(x, pt.to_tensor(labels), pt.to_tensor(ilen),
                           pt.to_tensor(llen), reduction="sum",
                           norm_by_times=flag)
        loss.backward()
        grads.append((float(loss), x.grad.numpy()))
    assert grads[0][0] == grads[1][0]
    np.testing.assert_allclose(grads[1][1], grads[0][1] / ilen[None, :, None],
                               rtol=1e-6, atol=1e-9)
    jx = JT(logits)
    jx.stop_gradient = False
    JF.ctc_loss(jx, JT(labels), JT(ilen), JT(llen), reduction="sum",
                norm_by_times=True).backward()
    sweep_close(jx.grad.numpy(), grads[0][1], 10 * FP32_TOL, "JAX drops it")


def test_hsigmoid_loss_matches_jax_on_the_default_tree():
    x, w, b = _x(8, 5), _x(9, 5, seed=1), _x(9, seed=2)
    y = np.random.RandomState(3).randint(0, 10, (8,)).astype(np.int64)
    twin_check(lambda a, l, u, v: JF.hsigmoid_loss(a, l, 10, u, v),
               lambda a, l, u, v: PF.hsigmoid_loss(a, l, 10, u, v),
               [x, y, w, b], diff=(0, 2, 3))
    twin_check(lambda a, l, u: JF.hsigmoid_loss(a, l, 10, u, is_sparse=True),
               lambda a, l, u: PF.hsigmoid_loss(a, l, 10, u, is_sparse=True),
               [x, y, w], diff=(0, 2))
    # Paddle's [N, 1] labels (the JAX package's gather fails on them)
    args = [pt.to_tensor(a) for a in (x, y[:, None], w)]
    np.testing.assert_array_equal(
        PF.hsigmoid_loss(args[0], args[1], 10, args[2]).numpy(),
        PF.hsigmoid_loss(args[0], pt.to_tensor(y), 10, args[2]).numpy())


def test_hsigmoid_loss_matches_jax_on_a_custom_tree():
    x, w = _x(6, 4), _x(7, 4, seed=1)
    y = np.array([0, 1, 2, 3, 1, 0], np.int64)
    table = np.array([[0, 1, 3], [0, 1, 4], [0, 2, 5], [0, 2, -1]], np.int64)
    code = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 1], [1, 1, 0]], np.float32)
    twin_check(lambda a, l, u, t, c: JF.hsigmoid_loss(a, l, 4, u, None, t, c),
               lambda a, l, u, t, c: PF.hsigmoid_loss(a, l, 4, u, None, t, c),
               [x, y, w, table, code], diff=(0, 2))


def test_hsigmoid_layer_matches_jax_and_trains():
    with unique_name.guard():
        jl = jnn.HSigmoidLoss(16, num_classes=10)
    tl = pnn.HSigmoidLoss(16, num_classes=10)
    load_jax_state(tl, jax_state(jl))
    rng = np.random.RandomState(0)
    x = rng.randn(32, 16).astype(np.float32)
    y = rng.randint(0, 10, (32,)).astype(np.int64)
    per = twin_check(lambda a, l: jl(a, l), lambda a, l: tl(a, l), [x, y])[0]
    assert list(per.shape) == [32, 1]
    # the oracle: tests/test_api_audit_round4.py::test_hsigmoid_loss_trains
    opt = pt.optimizer.SGD(learning_rate=0.5, parameters=tl.parameters())
    losses = []
    for _ in range(25):
        loss = tl(pt.to_tensor(x), pt.to_tensor(y)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses


def test_hsigmoid_custom_layer_holds_a_row_a_class():
    """Declared: with ``is_custom`` the layer holds ``num_classes`` rows, as
    Paddle sizes it for a caller's tree; the JAX layer keeps
    ``num_classes - 1``."""
    tl = pnn.HSigmoidLoss(4, num_classes=5, is_custom=True)
    assert list(tl.weight.shape) == [5, 4] and list(tl.bias.shape) == [5]
    table = pt.to_tensor(np.array([[4, 0], [4, 1], [4, 2], [4, 3], [4, -1]]))
    code = pt.to_tensor(np.ones((5, 2), np.float32))
    out = tl(pt.to_tensor(_x(3, 4)), pt.to_tensor(np.array([0, 3, 4])),
             table, code)
    assert list(out.shape) == [3, 1]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_margin_cross_entropy_matches_jax(reduction):
    logits = np.tanh(_x(6, 10))
    label = np.random.RandomState(1).randint(0, 10, (6, 1)).astype(np.int64)
    kw = dict(margin1=1.0, margin2=0.5, margin3=0.1, scale=16.0,
              reduction=reduction)
    out = twin_check(lambda a, y: JF.margin_cross_entropy(a, y, **kw),
                     lambda a, y: PF.margin_cross_entropy(a, y, **kw),
                     [logits, label])[0]
    if reduction == "none":    # tests/test_api_audit_round4.py's oracle
        assert list(out.shape) == [6, 1]
    twin_check(lambda a, y: JF.margin_cross_entropy(
                   a, y, return_softmax=True, **kw)[1],
               lambda a, y: PF.margin_cross_entropy(
                   a, y, return_softmax=True, **kw)[1],
               [logits, label[:, 0]])


def test_margin_cross_entropy_reduces_to_plain_ce_and_refuses_a_group():
    logits = np.tanh(_x(6, 10, seed=2))
    label = np.random.RandomState(2).randint(0, 10, (6,)).astype(np.int64)
    got = PF.margin_cross_entropy(pt.to_tensor(logits), pt.to_tensor(label),
                                  1.0, 0.0, 0.0, 4.0).numpy()
    want = torch.nn.functional.cross_entropy(torch.from_numpy(logits * 4.0),
                                             torch.from_numpy(label))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)
    harder = PF.margin_cross_entropy(pt.to_tensor(logits),
                                     pt.to_tensor(label), margin2=0.3,
                                     scale=4.0).numpy()
    assert harder > got
    with pytest.raises(NotImplementedError, match="A8"):
        PF.margin_cross_entropy(pt.to_tensor(logits), pt.to_tensor(label),
                                group=object())


# ------------------------------------------------------------ sampling ----

def test_class_center_sample_given_the_draw_matches_jax(monkeypatch):
    label = np.array([2, 7, 7, 1, 15], np.int64)
    noise = np.random.RandomState(4).uniform(0, 1, 20).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jax.numpy.asarray(noise))
    jr, js = JF.class_center_sample(JT(label), 20, 8)
    tr, ts = pc._class_center_sample_raw(torch.from_numpy(label),
                                         torch.from_numpy(noise), 20, 8)
    np.testing.assert_array_equal(ts.numpy(), js.numpy())
    np.testing.assert_array_equal(tr.numpy(), jr.numpy())


def test_class_center_sample_keeps_the_positives_and_replays():
    """The oracle (tests/test_api_audit_round4.py::test_class_center_sample)
    and seeded replay."""
    label = pt.to_tensor(np.array([2, 7, 7, 1], np.int64))
    pt.seed(5)
    remapped, sampled = PF.class_center_sample(label, 20, 6)
    s = sampled.numpy()
    assert len(s) == 6 and len(set(s.tolist())) == 6
    assert {1, 2, 7} <= set(s.tolist())
    for orig, rm in zip([2, 7, 7, 1], remapped.numpy()):
        assert s[rm] == orig
    pt.seed(5)
    again = PF.class_center_sample(label, 20, 6)[1].numpy()
    np.testing.assert_array_equal(again, s)
    with pytest.raises(NotImplementedError, match="A8"):
        PF.class_center_sample(label, 20, 6, group=object())


@pytest.mark.parametrize("maxlen,dtype", [(None, "int64"), (7, "float32"),
                                          (3, "bool")])
def test_sequence_mask_matches_jax(maxlen, dtype):
    lengths = np.array([[1, 4], [0, 5]], np.int64)
    got = PF.sequence_mask(pt.to_tensor(lengths), maxlen, dtype)
    want = JF.sequence_mask(JT(lengths), maxlen, dtype).numpy()
    assert got.dtype == pt.framework.dtype.convert_dtype(dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------- sparse attention ----

def _band(b, h, s, width):
    cols = [list(range(max(0, i - width + 1), i + 1)) for i in range(s)]
    offset = np.zeros((b, h, s + 1), np.int32)
    offset[..., 1:] = np.cumsum([len(c) for c in cols])
    flat = np.tile(np.array([j for c in cols for j in c], np.int32),
                   (b, h, 1))
    return offset, flat, cols


@pytest.mark.parametrize("masks", [False, True])
def test_sparse_attention_matches_jax(masks):
    b, h, s, d = 2, 2, 8, 4
    q, k, v = (_x(b, h, s, d, seed=i) for i in range(3))
    offset, cols, _ = _band(b, h, s, 3)
    arrays = [q, k, v, offset, cols]
    if masks:
        kpm = np.ones((b, s), np.float32)
        kpm[1, 5:] = 0
        am = 0.1 * _x(b, h, s, s, seed=5)
        twin_check(lambda *a: JF.sparse_attention(*a[:5], a[5], a[6]),
                   lambda *a: PF.sparse_attention(*a[:5], a[5], a[6]),
                   arrays + [kpm, am], diff=(0, 1, 2))
    else:
        twin_check(JF.sparse_attention, PF.sparse_attention, arrays,
                   diff=(0, 1, 2))


def test_sparse_attention_as_the_oracles():
    """``tests/test_flat_api_batch.py``'s masked-dense and diagonal
    cases."""
    b, h, s, d = 1, 2, 8, 4
    q, k, v = (_x(b, h, s, d, seed=i) for i in range(3))
    offset, cols, rows = _band(b, h, s, 2)
    out = PF.sparse_attention(*(pt.to_tensor(a) for a in
                                (q, k, v, offset, cols))).numpy()
    mask = np.zeros((s, s), bool)
    for i, row in enumerate(rows):
        mask[i, row] = True
    sc = np.where(mask, q @ k.transpose(0, 1, 3, 2) / np.sqrt(d), -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    np.testing.assert_allclose(out, (p / p.sum(-1, keepdims=True)) @ v,
                               rtol=1e-4, atol=1e-5)
    qd = pt.to_tensor(q[:, :1, :4], stop_gradient=False)
    diag = np.arange(5, dtype=np.int32)[None, None]
    out = PF.sparse_attention(qd, pt.to_tensor(k[:, :1, :4]),
                              pt.to_tensor(v[:, :1, :4]),
                              pt.to_tensor(diag),
                              pt.to_tensor(diag[..., :4]))
    out.sum().backward()
    assert qd.grad is not None
    np.testing.assert_allclose(out.numpy(), v[:, :1, :4], rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- amp ----

AMP_CASES = [
    ("conv2d_transpose", lambda F, t: F.conv2d_transpose(
        t((1, 4, 5, 5)), t((4, 2, 3, 3), 1))),
    ("group_norm", lambda F, t: F.group_norm(t((2, 4, 3, 3)), 2)),
    ("instance_norm", lambda F, t: F.instance_norm(t((2, 4, 3, 3)))),
    ("ctc_loss", lambda F, t: F.ctc_loss(
        t((6, 2, 5)), t((2, 2), None, "int"), t((2,), None, "len6"),
        t((2,), None, "len2"))),
    ("interpolate", lambda F, t: F.interpolate(t((1, 2, 3, 3)),
                                               scale_factor=2)),
    ("pixel_shuffle", lambda F, t: F.pixel_shuffle(t((1, 4, 2, 2)), 2)),
]


def _maker(pkg):
    def t(shape, seed=0, kind="f"):
        if kind == "int":
            a = np.ones(shape, np.int64)
        elif kind.startswith("len"):
            a = np.full(shape, int(kind[3:]), np.int64)
        else:
            a = _x(*shape, seed=seed)
        return JT(a) if pkg == "jax" else pt.to_tensor(a)
    return t


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name,fn", AMP_CASES, ids=[c[0] for c in AMP_CASES])
def test_amp_dtypes_match_jax(level, name, fn):
    """O1: the transposed conv (white list) in bf16, the group and instance
    norms and CTC (black list) in fp32, the others as given; O2 casts the
    black list only."""
    with jp.amp.auto_cast(level=level, dtype="bfloat16"):
        want = fn(JF, _maker("jax")).dtype
    with pt.amp.auto_cast(level=level, dtype="bfloat16"):
        got = fn(PF, _maker("port")).dtype
    assert str(got).split(".")[-1] == str(want).split(".")[-1], (got, want)


def test_rms_norm_runs_fp32_under_auto_cast_as_jax():
    with unique_name.guard():
        jl = jnn.RMSNorm(4)
    tl = pnn.RMSNorm(4)
    x = _x(2, 4)
    with jp.amp.auto_cast(level="O1"):
        want = jl(JT(x).astype("bfloat16")).dtype
    with pt.amp.auto_cast(level="O1"):
        got = tl(pt.to_tensor(x).astype("bfloat16")).dtype
    assert str(got).split(".")[-1] == str(want).split(".")[-1] == "float32"


def test_decorate_o2_keeps_the_new_norms_fp32_as_jax():
    """``amp.decorate(O2)`` casts the transposed conv to bf16 and leaves
    ``GroupNorm``, ``InstanceNorm2D``, ``RMSNorm``, ``LocalResponseNorm``
    and ``SpectralNorm`` fp32, in both packages."""
    def build(nn):
        return nn.Sequential(nn.Conv2DTranspose(4, 4, 3), nn.GroupNorm(2, 4),
                             nn.InstanceNorm2D(4), nn.RMSNorm(4),
                             nn.LocalResponseNorm(3), nn.SpectralNorm([4, 4]))

    with unique_name.guard():
        jm = jp.amp.decorate(build(jnn), level="O2", dtype="bfloat16")
    tm = pt.amp.decorate(build(pnn), level="O2", dtype="bfloat16")
    want = {n: str(p.dtype).split(".")[-1] for n, p in jm.named_parameters()}
    got = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert got == want
    assert got["0.weight"] == "bfloat16" and got["1.weight"] == "float32"
