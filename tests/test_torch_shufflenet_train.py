"""A ShuffleNetV2 training twin: the port's
(``paddle_tpu_torch/vision/models/shufflenetv2.py``) against the JAX
package's on the CPU, with the same weights (``load_jax_state``) and numpy
inputs.

``shufflenet_v2_x0_25`` (10 classes) trained 3 Momentum(0.01, 0.9, weight
decay 1e-4) steps at batch 4 x 64 x 64 in train mode (batch statistics):
each loss, every gradient of every step, the parameters and the running
statistics after the steps within ``SPREAD`` (10) times the port's own
fp32 spread (its distance from the same steps in fp64), as the ResNet-50
and MobileNetV3 twins hold theirs (random-init conv nets with batch norms
amplify fp32 rounding; ``ROADMAP.md`` C).
"""
import copy

import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.vision import models as PM
from tests.torch_port_util import model_pair, spread_check


def test_shufflenet_v2_x0_25_momentum_steps_match_jax():
    jm, tm = model_pair(lambda: JM.shufflenet_v2_x0_25(num_classes=10),
                        lambda device: PM.shufflenet_v2_x0_25(
                            num_classes=10, device=device), 6)
    t64 = copy.deepcopy(tm).double()
    jopt = paddle.optimizer.Momentum(0.01, 0.9, parameters=jm.parameters(),
                                     weight_decay=1e-4)
    opts = [pt.optimizer.Momentum(0.01, 0.9, parameters=m.parameters(),
                                  weight_decay=1e-4) for m in (tm, t64)]
    for m in (jm, tm, t64):
        m.train()
    jparams, p64 = dict(jm.named_parameters()), dict(t64.named_parameters())
    rng = np.random.RandomState(12)
    for step in range(3):
        x = rng.randn(4, 3, 64, 64).astype(np.float32)
        y = rng.randint(0, 10, (4, 1)).astype(np.int64)
        jloss = JF.cross_entropy(jm(Tensor(x)), Tensor(y))
        losses = [PF.cross_entropy(m(torch.from_numpy(x).to(dt)),
                                   torch.from_numpy(y))
                  for m, dt in ((tm, torch.float32), (t64, torch.float64))]
        for loss in (jloss, *losses):
            loss.backward()
        spread_check(float(losses[0].detach()), float(jloss),
                     float(losses[1].detach()), f"loss {step}")
        for name, p in tm.named_parameters():
            want = np.asarray(jparams[name].grad.numpy())
            spread_check(p.grad.numpy(), want, p64[name].grad.numpy(),
                         f"step {step} grad {name}")
        for opt in (jopt, *opts):
            opt.step()
            opt.clear_grad()
    for name, p in tm.named_parameters():
        spread_check(p.detach().numpy(), np.asarray(jparams[name].numpy()),
                     p64[name].detach().numpy(), name)
    jbufs, b64 = dict(jm.named_buffers()), dict(t64.named_buffers())
    for name, b in tm.named_buffers():
        # a batch norm fed by another train-mode batch norm through a 1 x 1
        # conv sees batch means that are zero in exact arithmetic: its
        # running mean is rounding noise of the running deviation's size
        scale = (np.linalg.norm(np.sqrt(b64[name[:-5] + "_variance"]
                                        .numpy()))
                 if name.endswith("._mean") else None)
        spread_check(b.numpy(), np.asarray(jbufs[name].numpy()),
                     b64[name].numpy(), name, scale)
    assert float(tm.conv1[1]._mean.abs().sum()) > 0
