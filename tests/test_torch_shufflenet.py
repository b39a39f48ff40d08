"""The port's ShuffleNetV2 (``paddle_tpu_torch/vision/models/
shufflenetv2.py``) against the JAX package's on the CPU, with the same
weights (``load_jax_state``, batch-norm buffers included) and numpy inputs.

Limits: eval logits of every factory at 2 x 3 x 64 x 64, 10 classes,
within ``FP32_TOL`` (1e-5) of the largest JAX logit. The wide factories
are in ``tests/test_torch_shufflenet_wide.py`` and the training twin in
``tests/test_torch_shufflenet_train.py`` (xdist spreads the files).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.vision import models as JM

from paddle_tpu_torch.vision import models as PM
from tests.torch_port_util import FP32_TOL, model_pair, sweep_close

FACTORIES = ("shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
             "shufflenet_v2_x0_5", "shufflenet_v2_swish")
#: state entries (parameters, then batch-norm buffers) and parameters
SIZES = (282, 170)


def check_factory(factory, seed=3):
    """The module tree, the state's names and shapes and the eval logits of
    ``factory`` against the JAX model's."""
    jm, tm = model_pair(lambda: getattr(JM, factory)(num_classes=10),
                        lambda device: getattr(PM, factory)(
                            num_classes=10, device=device), seed)
    jstate, tstate = jm.state_dict(), tm.state_dict()
    assert list(tstate) == list(jstate)
    assert (len(tstate), len(tm.parameters())) == SIZES
    assert [n for n, _ in tm.named_sublayers()] == [
        n for n, _ in jm.named_sublayers()]
    for name, v in tstate.items():
        assert tuple(v.shape) == tuple(jstate[name].shape), name
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    got = tm(torch.from_numpy(x))
    assert type(got) is torch.Tensor and tuple(got.shape) == (2, 10)
    want = np.asarray(jm(Tensor(x)).numpy())
    assert np.abs(want).max() > 0
    sweep_close(got.detach().numpy(), want, FP32_TOL, factory)


@pytest.mark.parametrize("factory", FACTORIES)
def test_eval_logits_and_state_match_jax(factory):
    check_factory(factory)


@pytest.mark.parametrize("factory", FACTORIES)
def test_factories_refuse_pretrained_weights(factory):
    with pytest.raises(ValueError, match="download"):
        getattr(PM, factory)(pretrained=True, device="cpu")


def test_headless_model_and_the_card_default():
    m = PM.ShuffleNetV2(0.25, num_classes=0, with_pool=False, device="cpu")
    out = m(torch.zeros(1, 3, 64, 64))
    assert tuple(out.shape) == (1, 512, 2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PM.shufflenet_v2_x0_25(num_classes=10)


def test_blocks_keep_a_channels_last_input_channels_last():
    m = PM.shufflenet_v2_x0_25(num_classes=10, device="cpu").eval()
    x = torch.randn(2, 3, 64, 64)
    cl = x.contiguous(memory_format=torch.channels_last)
    block = m.blocks[5]
    seen = {}
    block.register_forward_hook(lambda mod, i, o: seen.setdefault("y", o))
    with torch.no_grad():
        got = m(cl)
        want = m(x)
    assert seen["y"].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
