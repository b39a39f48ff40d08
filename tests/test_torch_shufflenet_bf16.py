"""ShuffleNetV2 x1.0 in bf16 against fp32, in the port and in the JAX
package, on the CPU: the witness that the port's bf16 gap is the model's.

Both packages run the same weights (``load_jax_state``) in train mode
(batch statistics) on one seeded batch of 2 x 3 x 96 x 96, in fp32 and in
the bf16 recipe (``amp.decorate(level="O2")`` in JAX, ``to(bfloat16)``
with the batch norms kept fp32 in the port), traced stage by stage: the
stem, the 16 blocks, ``conv_last``, the pooled head. Limits:

- the port's fp32 stages within ``FP32_STAGE_TOL`` (1e-4) relative L2 of
  JAX's fp32 stages;
- the port's bf16-against-fp32 gap at every stage within a factor
  ``GAP_RATIO`` (4/3) of JAX's own gap: the gap grows about 1.2x a block
  in both packages alike, so it is the model's, not the port's;
- each stage alone (fed the fp32 run's input of that stage, rounded to
  bf16) within ``LOCAL_STEPS`` (2) bf16 steps relative L2 of the fp32
  stage, in both packages: what one stage adds is a rounding;
- the cause: the fp32 model fed the input rounded to bf16 once, with no
  bf16 arithmetic after, moves the logits by at least a quarter of the
  whole bf16 gap (a random-init network with train-mode batch norms
  amplifies any perturbation).

``chip_smoke.py``'s ``shufflenet_vs_plain`` holds the card to the same
stage limit. ``-s`` prints the readings.
"""
import copy

import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as JM

from paddle_tpu_torch.vision import models as PM
from tests.torch_port_util import model_pair

FP32_STAGE_TOL = 1e-4
GAP_RATIO = 4.0 / 3.0
LOCAL_STEPS = 2
BF16_STEP = 2.0 ** -7


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_stages(m):
    return ([lambda h: m.maxpool(m.conv1(h))] + list(m.blocks)
            + [m.conv_last, lambda h: m.fc(paddle.flatten(m.pool(h), 1))])


def _port_stages(m):
    return ([lambda h: m.maxpool(m.conv1(h))] + list(m.blocks)
            + [m.conv_last, lambda h: m.fc(torch.flatten(m.pool(h), 1))])


def _jax_run(stages, x, dtype):
    """Each stage's output (fp32 numpy) of the run from ``x`` in
    ``dtype``."""
    h, outs = paddle.to_tensor(x).astype(dtype), []
    for stage in stages:
        h = stage(h)
        outs.append(np.asarray(h.astype("float32").numpy()))
    return outs


def _port_run(stages, x, dtype):
    h, outs = torch.from_numpy(x).to(dtype), []
    with torch.no_grad():
        for stage in stages:
            h = stage(h)
            outs.append(h.float().numpy())
    return outs


def test_the_ports_bf16_gap_is_the_jax_packages():
    jm, tm = model_pair(lambda: JM.shufflenet_v2_x1_0(num_classes=1000),
                        lambda device: PM.shufflenet_v2_x1_0(
                            num_classes=1000, device=device), 1)
    jm16 = paddle.amp.decorate(copy.deepcopy(jm), level="O2",
                               dtype="bfloat16")
    tm16 = copy.deepcopy(tm).to(torch.bfloat16)
    for m in tm16.modules():
        if type(m).__name__.startswith("BatchNorm"):
            m.float()
    for m in (jm, jm16, tm, tm16):
        m.train()
    x = np.random.RandomState(3).randn(2, 3, 96, 96).astype(np.float32)
    j32 = _jax_run(_jax_stages(jm), x, "float32")
    j16 = _jax_run(_jax_stages(jm16), x, "bfloat16")
    t32 = _port_run(_port_stages(tm), x, torch.float32)
    t16 = _port_run(_port_stages(tm16), x, torch.bfloat16)
    gaps = [(_rel(j16[i], j), _rel(t16[i], t))
            for i, (j, t) in enumerate(zip(j32, t32))]
    print("bf16 against fp32 by stage (JAX, port):", gaps)
    for i, (j, t) in enumerate(zip(j32, t32)):
        assert _rel(t, j) <= FP32_STAGE_TOL, (i, _rel(t, j))
        jgap, tgap = gaps[i]
        assert jgap / GAP_RATIO <= tgap <= jgap * GAP_RATIO, (i, tgap, jgap)
    assert _rel(t16[-2], t32[-2]) >= 10 * _rel(t16[0], t32[0])

    # each stage alone, fed the fp32 chain's input
    local = LOCAL_STEPS * BF16_STEP
    ins = [x] + j32[:-1]
    for i, (js, ts) in enumerate(zip(_jax_stages(jm16),
                                     _port_stages(tm16))):
        j = np.asarray(js(paddle.to_tensor(ins[i]).astype("bfloat16"))
                       .astype("float32").numpy())
        with torch.no_grad():
            t = ts(torch.tensor(ins[i]).to(torch.bfloat16)).float().numpy()
        print(f"stage {i} alone (JAX, port): {_rel(j, j32[i])}, "
              f"{_rel(t, t32[i])}")
        assert _rel(j, j32[i]) <= local, (i, _rel(j, j32[i]))
        assert _rel(t, t32[i]) <= local, (i, _rel(t, t32[i]))

    # the cause: one rounding of the input, fp32 after it
    rounded = _port_run(_port_stages(tm), torch.from_numpy(x).to(
        torch.bfloat16).float().numpy(), torch.float32)
    print("logits: input rounded once, fp32 after:",
          _rel(rounded[-1], t32[-1]), "bf16:", _rel(t16[-1], t32[-1]))
    assert _rel(rounded[-1], t32[-1]) >= 0.25 * _rel(t16[-1], t32[-1])
