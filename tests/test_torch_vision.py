"""The port's vision models (``paddle_tpu_torch/vision/models``) against the
JAX package's on the CPU, with the same weights (``load_jax_state``, batch
norm buffers included) and numpy inputs.

Limits:
* eval logits of resnet18, resnet50, resnext50_32x4d and wide_resnet50_2
  at 2 x 3 x 32 x 32, 10 classes: ``FP32_TOL`` (1e-5) absolute, the same
  fp32 arithmetic in another order through up to 50 layers (2.1e-7 the
  largest gap measured);
* resnet50 trained 3 Momentum(0.01, 0.9, weight decay 1e-4) steps at batch
  4 x 48 x 48 in train mode (batch statistics): each loss, every gradient of
  every step, the parameters and every batch norm's running mean and
  variance after the steps within ``SPREAD`` (10) times the port's own fp32
  rounding spread, its L2 distance from the same steps run in fp64 (the
  largest ratio measured was 4.5). The spreads are 1-4 % for the first
  step's gradients, whose random-init magnitudes grow by orders towards
  conv1, and reach tens of percent by the third step: at lr 0.01 those
  gradients move the weights far;
* LeNet: logits within 1e-5 and a 5-step Adam(1e-3) loss curve within
  1e-5.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.vision import models as PM
from tests.torch_port_util import FP32_TOL, model_pair, spread_check

ATOL = FP32_TOL
FACTORIES = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
             "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
             "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
             "resnext152_32x4d", "resnext152_64x4d")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(factory, seed=3, **kw):
    return model_pair(lambda: getattr(JM, factory)(num_classes=10, **kw),
                      lambda device: getattr(PM, factory)(
                          num_classes=10, device=device, **kw), seed)


def _close(got, want, atol=ATOL, rtol=0.0, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype("float32").numpy()),
                               atol=atol, rtol=rtol, **kw)


def test_module_tree_and_state_names_match_jax():
    jm, tm = _pair("resnet50")
    jstate = jm.state_dict()
    tstate = tm.state_dict()
    # paddle's order: the parameters, then the persistable buffers
    assert list(tstate)[:3] == ["conv1.weight", "bn1.weight", "bn1.bias"]
    assert list(tstate) == list(jstate) and len(tstate) == 267
    for name in ("layer1.0.downsample.0.weight", "layer4.2.bn3._variance",
                 "fc.weight"):
        assert name in tstate
    assert len(list(tm.parameters())) == len(jm.parameters()) == 161


@pytest.mark.parametrize("factory", ["resnet18", "resnet50",
                                     "resnext50_32x4d", "wide_resnet50_2"])
def test_eval_logits_match_jax(factory):
    jm, tm = _pair(factory)
    x = _x(2, 3, 32, 32)
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 10)
    _close(got, jm(Tensor(x)))


@pytest.mark.parametrize("factory", FACTORIES)
def test_factories_refuse_pretrained_weights(factory):
    with pytest.raises(ValueError, match="download"):
        getattr(PM, factory)(pretrained=True, device="cpu")


def test_models_default_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PM.resnet18(num_classes=10)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PM.LeNet()


# SPREAD (tests/torch_port_util.py): the largest ratio measured on the CPU
# was 4.5 (step 3's fc.bias gradient), most are near 1


def test_resnet50_momentum_steps_match_jax():
    # Batch 4 of 48 x 48: every batch norm averages at least 16 values (at
    # 32 x 32 layer4's average 4, where JAX's fp32 backward stands 45 % from
    # the fp64 result and the port's 1.5 %). A randomly initialised
    # ResNet-50's gradients grow by orders of magnitude towards conv1 and
    # amplify fp32 rounding (the port's fp32 and fp64 gradients differ by
    # 1-4 % in L2), so each value is held to the port's own fp32 spread:
    # the same steps run in fp64 beside it (SPREAD).
    jm, tm = _pair("resnet50")
    t64 = copy.deepcopy(tm).double()
    jopt = paddle.optimizer.Momentum(0.01, 0.9, parameters=jm.parameters(),
                                     weight_decay=1e-4)
    opts = [pt.optimizer.Momentum(0.01, 0.9, parameters=m.parameters(),
                                  weight_decay=1e-4) for m in (tm, t64)]
    for m in (jm, tm, t64):
        m.train()
    jparams, p64 = dict(jm.named_parameters()), dict(t64.named_parameters())
    rng = np.random.RandomState(11)
    for step in range(3):
        x = rng.randn(4, 3, 48, 48).astype(np.float32)
        y = rng.randint(0, 10, (4, 1)).astype(np.int64)
        jloss = JF.cross_entropy(jm(Tensor(x)), Tensor(y))
        losses = [PF.cross_entropy(m(torch.from_numpy(x).to(dt)),
                                   torch.from_numpy(y))
                  for m, dt in ((tm, torch.float32), (t64, torch.float64))]
        for loss in (jloss, *losses):
            loss.backward()
        spread_check(float(losses[0].detach()), float(jloss),
                     float(losses[1].detach()),
                     f"loss {step}")
        for name, p in tm.named_parameters():     # every gradient
            want = np.asarray(jparams[name].grad.numpy())
            spread_check(p.grad.numpy(), want, p64[name].grad.numpy(),
                         f"step {step} grad {name}")
        for opt in (jopt, *opts):
            opt.step()
            opt.clear_grad()
    for name, p in tm.named_parameters():
        want = np.asarray(jparams[name].numpy())
        spread_check(p.detach().numpy(), want, p64[name].detach().numpy(),
                     name)
    jbufs, b64 = dict(jm.named_buffers()), dict(t64.named_buffers())
    for name, b in tm.named_buffers():            # the running statistics
        spread_check(b.numpy(), np.asarray(jbufs[name].numpy()),
                     b64[name].numpy(), name)
    assert float(tm.bn1._mean.abs().sum()) > 0


def test_lenet_forward_and_adam_steps_match_jax():
    jm, tm = model_pair(lambda: JM.LeNet(), lambda device: PM.LeNet(
        device=device), seed=5)
    x = _x(16, 1, 28, 28)
    _close(tm(torch.from_numpy(x)), jm(Tensor(x)))
    jopt = paddle.optimizer.Adam(1e-3, parameters=jm.parameters())
    topt = pt.optimizer.Adam(1e-3, parameters=tm.parameters())
    rng = np.random.RandomState(12)
    jl, tl = [], []
    for _ in range(5):
        x = rng.randn(16, 1, 28, 28).astype(np.float32)
        y = rng.randint(0, 10, (16, 1)).astype(np.int64)
        for loss, opt, out in (
                (JF.cross_entropy(jm(Tensor(x)), Tensor(y)), jopt, jl),
                (PF.cross_entropy(tm(torch.from_numpy(x)),
                                  torch.from_numpy(y)), topt, tl)):
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tl[-1] < tl[0]
