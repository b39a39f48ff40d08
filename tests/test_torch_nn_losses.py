"""The port's loss functionals and layers
(``paddle_tpu_torch/nn/functional/loss.py``, ``nn/layer/loss.py``) against
the JAX package's on the CPU, on seeded numpy inputs: forward and the
gradient with respect to the predictions for every reduction and option,
the options where PyTorch's loss of the same name differs (Huber
``smooth_l1_loss(delta)``, the focal loss's ``"sum"`` and ``normalizer``,
``kl_div``'s ``"batchmean"``, ``nll_loss`` with ``weight`` and
``ignore_index``, ``binary_cross_entropy_with_logits`` with ``weight`` and
``pos_weight``), every loss layer, and the dtypes ``amp.auto_cast`` gives.

Limits: ``FP32_TOL`` (1e-5) of the largest magnitude for the losses, ten
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
from tests.torch_port_util import (FP32_TOL, port_cpu,  # noqa: F401
                                   sweep_close, twin_check)

pytestmark = pytest.mark.usefixtures("port_cpu")

R = np.random.RandomState(0)
X = R.randn(6, 5).astype(np.float32)                 # predictions, logits
Y = R.randn(6, 5).astype(np.float32)
Z = R.randn(6, 5).astype(np.float32)
P = R.uniform(0.05, 0.95, (6, 5)).astype(np.float32)   # probabilities
Q = R.uniform(0.05, 0.95, (6, 5)).astype(np.float32)
LOGP = np.log(Q / Q.sum(1, keepdims=True)).astype(np.float32)
W = R.uniform(0.2, 1.5, (6, 5)).astype(np.float32)
PW = R.uniform(0.5, 3.0, (5,)).astype(np.float32)
SIGN = np.where(R.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
SIGN2 = np.where(R.rand(6, 5) > 0.5, 1.0, -1.0).astype(np.float32)
LAB = np.array([0, 4, 2, 2, 1, 3], np.int64)
CW = R.uniform(0.2, 2.0, (5,)).astype(np.float32)

REDUCTIONS = ["mean", "sum", "none"]

#: (loss, inputs, keyword options, indices of the differentiated inputs)
CASES = [
    ("binary_cross_entropy", (P, Q), {}, (0,)),
    ("binary_cross_entropy_with_logits", (X, Q), {}, (0,)),
    ("binary_cross_entropy_with_logits", (X, Q, W), {}, (0,)),
    ("bce_logits_pos", (X, Q, PW), {}, (0,)),
    ("bce_logits_weight_pos", (X, Q, W, PW), {}, (0,)),
    ("nll_loss", (LOGP, LAB), {}, (0,)),
    ("nll_loss", (LOGP, LAB), {"ignore_index": 2}, (0,)),
    ("nll_loss", (LOGP, LAB, CW), {"ignore_index": 2}, (0,)),
    ("kl_div", (LOGP, Q), {}, (0, 1)),
    ("smooth_l1_loss", (X, Y), {}, (0, 1)),
    ("smooth_l1_loss", (X, Y), {"delta": 0.3}, (0, 1)),
    ("smooth_l1_loss", (X, Y), {"delta": 2.5}, (0, 1)),
    ("huber_loss", (X, Y), {"delta": 0.7}, (0, 1)),
    ("margin_ranking_loss", (X[:, 0], Y[:, 0], SIGN), {"margin": 0.3},
     (0, 1)),
    ("hinge_embedding_loss", (X, SIGN2), {"margin": 0.6}, (0,)),
    ("cosine_embedding_loss", (X, Y, SIGN), {"margin": 0.1}, (0, 1)),
    ("triplet_margin_loss", (X, Y, Z), {}, (0, 1, 2)),
    ("triplet_margin_loss", (X, Y, Z), {"p": 1.0, "swap": True,
                                        "margin": 0.5}, (0, 1, 2)),
    ("triplet_margin_with_distance_loss", (X, Y, Z), {"swap": True},
     (0, 1, 2)),
    ("sigmoid_focal_loss", (X, Q), {}, (0,)),
    ("sigmoid_focal_loss", (X, Q, np.array([3.0], np.float32)),
     {"alpha": 0.4, "gamma": 1.0}, (0,)),
    ("multi_label_soft_margin_loss", (X, Q), {}, (0,)),
    ("multi_label_soft_margin_loss", (X, Q, PW), {}, (0,)),
]
REDUCED = [(n, a, dict(kw, reduction=r), d) for n, a, kw, d in CASES
           for r in REDUCTIONS]
OTHERS = [
    ("kl_div", (LOGP, Q), {"reduction": "batchmean"}, (0, 1)),
    ("square_error_cost", (X, Y), {}, (0, 1)),
    ("log_loss", (P, Q), {}, (0,)),
    ("log_loss", (P, Q), {"epsilon": 0.01}, (0,)),
    ("softmax_with_cross_entropy", (X, LAB[:, None]), {}, (0,)),
    ("softmax_with_cross_entropy", (X, LAB[:, None]),
     {"ignore_index": 2, "return_softmax": True}, (0,)),
    ("softmax_with_cross_entropy", (X, Q / Q.sum(1, keepdims=True)),
     {"soft_label": True}, (0,)),
    ("softmax_with_cross_entropy", (X.T.copy(), LAB[None]),
     {"axis": 0}, (0,)),
    ("npair_loss", (X, Y, np.array([0, 1, 0, 2, 1, 0], np.int64)), {},
     (0, 1)),
    ("npair_loss", (X, Y, np.array([0, 1, 0, 2, 1, 0], np.int64)),
     {"l2_reg": 0.05}, (0, 1)),
    ("dice_loss", (P, LAB[:, None]), {}, (0,)),
    ("dice_loss", (P, LAB[:, None]), {"epsilon": 0.1}, (0,)),
]


def _fn(F, name):
    if name == "bce_logits_pos":
        return lambda x, y, pw, **kw: F.binary_cross_entropy_with_logits(
            x, y, pos_weight=pw, **kw)
    if name == "bce_logits_weight_pos":
        return lambda x, y, w, pw, **kw: F.binary_cross_entropy_with_logits(
            x, y, w, pos_weight=pw, **kw)
    return getattr(F, name)


def _ids(cases):
    return [f"{n}-{'-'.join(str(v) for v in kw.values()) or 'default'}"
            f"-{len(a)}" for n, a, kw, _ in cases]


@pytest.mark.parametrize("name,arrays,kw,diff", REDUCED + OTHERS,
                         ids=_ids(REDUCED + OTHERS))
def test_loss_matches_jax(name, arrays, kw, diff):
    jf, pf = _fn(JF, name), _fn(PF, name)
    twin_check(lambda *a: jf(*a, **kw), lambda *a: pf(*a, **kw), arrays,
               diff=diff)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_binary_cross_entropy_weighs_each_element(reduction):
    """The JAX package raises a TypeError given a weight (its op takes the
    weight in the reduction's place, ROADMAP.md C); the port multiplies the
    elementwise loss, which the JAX package gives without one."""
    with pytest.raises(TypeError):
        JF.binary_cross_entropy(JT(P), JT(Q), JT(W), reduction=reduction)
    per = JF.binary_cross_entropy(JT(P), JT(Q), reduction="none").numpy() * W
    want = {"mean": per.mean(), "sum": per.sum(), "none": per}[reduction]
    got = PF.binary_cross_entropy(pt.to_tensor(P), pt.to_tensor(Q),
                                  pt.to_tensor(W), reduction=reduction)
    sweep_close(got.numpy(), want, FP32_TOL, reduction)
    layer = pnn.BCELoss(pt.to_tensor(W), reduction)
    sweep_close(layer(pt.to_tensor(P), pt.to_tensor(Q)).numpy(), want,
                FP32_TOL, "BCELoss")


def test_smooth_l1_is_huber_not_torchs():
    """``0.5 d^2`` below ``delta``, else ``delta (|d| - delta / 2)``: torch's
    ``smooth_l1_loss(beta)`` divides by ``beta`` and differs at every
    ``delta != 1``."""
    x, y = pt.to_tensor(X), pt.to_tensor(Y)
    d = np.abs(X.astype(np.float64) - Y)
    for delta in (0.3, 1.0, 2.5):
        want = np.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
        got = PF.smooth_l1_loss(x, y, "none", delta).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        torchs = torch.nn.functional.smooth_l1_loss(
            torch.from_numpy(X), torch.from_numpy(Y), reduction="none",
            beta=delta).numpy()
        assert np.allclose(torchs, want, rtol=1e-5) == (delta == 1.0)


def test_focal_loss_sums_by_default_and_divides_by_the_normalizer():
    x, y = pt.to_tensor(X), pt.to_tensor(Q)
    per = PF.sigmoid_focal_loss(x, y, reduction="none").numpy()
    np.testing.assert_allclose(PF.sigmoid_focal_loss(x, y).numpy(),
                               per.sum(), rtol=1e-6)
    n = pt.to_tensor(np.array([4.0], np.float32))
    np.testing.assert_allclose(PF.sigmoid_focal_loss(x, y, n).numpy(),
                               per.sum() / 4.0, rtol=1e-6)


def test_kl_div_batchmean_divides_by_the_batch_and_mean_by_every_element():
    x, y = pt.to_tensor(LOGP), pt.to_tensor(Q)
    total = PF.kl_div(x, y, "sum").numpy()
    np.testing.assert_allclose(PF.kl_div(x, y, "batchmean").numpy(),
                               total / 6, rtol=1e-6)
    np.testing.assert_allclose(PF.kl_div(x, y, "mean").numpy(), total / 30,
                               rtol=1e-6)


def test_nll_loss_mean_divides_by_the_kept_labels_weights():
    lab = LAB.copy()
    got = PF.nll_loss(pt.to_tensor(LOGP), pt.to_tensor(lab),
                      pt.to_tensor(CW), ignore_index=2).numpy()
    keep = lab != 2
    picked = -LOGP[np.arange(6), lab] * CW[lab]
    np.testing.assert_allclose(got, picked[keep].sum() / CW[lab][keep].sum(),
                               rtol=1e-6)


# ------------------------------------------------------------ layers ----

#: (layer, constructor arguments, forward inputs, differentiated inputs)
LAYERS = [
    ("NLLLoss", (), (LOGP, LAB), (0,)),
    ("NLLLoss", ("w", 1, "sum"), (LOGP, LAB), (0,)),
    ("BCELoss", (None, "sum"), (P, Q), (0,)),
    ("BCEWithLogitsLoss", (), (X, Q), (0,)),
    ("BCEWithLogitsLoss", ("W", "mean", "pw"), (X, Q), (0,)),
    ("KLDivLoss", ("batchmean",), (LOGP, Q), (0,)),
    ("SmoothL1Loss", ("mean", 0.4), (X, Y), (0, 1)),
    ("HuberLoss", ("sum", 0.4), (X, Y), (0, 1)),
    ("MarginRankingLoss", (0.2,), (X[:, 0], Y[:, 0], SIGN), (0, 1)),
    ("HingeEmbeddingLoss", (0.5,), (X, SIGN2), (0,)),
    ("CosineEmbeddingLoss", (0.2,), (X, Y, SIGN), (0, 1)),
    ("TripletMarginLoss", (0.5, 1.0, 1e-6, True), (X, Y, Z), (0, 1, 2)),
    ("SigmoidFocalLoss", (0.3, 1.5), (X, Q), (0,)),
    ("MultiLabelSoftMarginLoss", ("pw",), (X, Q), (0,)),
    ("TripletMarginWithDistanceLoss", (None, 0.7), (X, Y, Z), (0, 1, 2)),
    ("TripletMarginWithDistanceLoss", ("l1", 0.7, True), (X, Y, Z),
     (0, 1, 2)),
]


def _args(pkg, args):
    T = JT if pkg is jp else (lambda a: pt.to_tensor(a))
    named = {"w": T(CW), "W": T(W), "pw": T(PW),
             "l1": lambda a, b: pkg.sum(pkg.abs(a - b), axis=-1)}
    return [named[a] if isinstance(a, str) and a in named else a
            for a in args]


@pytest.mark.parametrize("name,args,arrays,diff", LAYERS,
                         ids=[f"{n}-{len(a)}" for n, a, _, _ in LAYERS])
def test_loss_layer_matches_jax(name, args, arrays, diff):
    jl = getattr(jnn, name)(*_args(jp, args))
    tl = getattr(pnn, name)(*_args(pt, args))
    assert tl.parameters() == []
    twin_check(jl, tl, arrays, diff=diff)


# --------------------------------------------------------------- amp ----

def _dt(t):
    return str(t.dtype).replace("torch.", "")


AMP = [c for c in CASES + OTHERS if c[0] not in ("npair_loss", "dice_loss")]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_gives_jaxs_dtypes(level):
    """The black list keeps ``bce_op``, ``bce_logits_op``, ``nll_loss_op``,
    ``kl_div_op``, ``sigmoid_focal_op`` and ``softmax_ce`` fp32 on bf16
    inputs; the others run as JAX's run."""
    for name, arrays, kw, _ in AMP:
        jf, pf = _fn(JF, name), _fn(PF, name)
        for src in ("float32", "bfloat16"):
            ja = [JT(a).astype(src) if a.dtype == np.float32 else JT(a)
                  for a in arrays]
            ta = [pt.to_tensor(a).astype(src) if a.dtype == np.float32
                  else pt.to_tensor(a) for a in arrays]
            with jp.amp.auto_cast(level=level, dtype="bfloat16"):
                jo = jf(*ja, **kw)
            with pt.amp.auto_cast(level=level, dtype="bfloat16"):
                to = pf(*ta, **kw)
            jo = jo if isinstance(jo, (tuple, list)) else [jo]
            to = to if isinstance(to, (tuple, list)) else [to]
            assert [_dt(t) for t in to] == [_dt(j) for j in jo], (
                name, kw, src, level)
