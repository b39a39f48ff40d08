"""The port's MobileNets (``paddle_tpu_torch/vision/models/mobilenet.py``)
against the JAX package's on the CPU, with the same weights
(``load_jax_state``, batch-norm buffers included) and numpy inputs.

Limits:
* eval logits of all four models at 2 x 3 x 32 x 32, 10 classes: within
  ``FP32_TOL`` (1e-5) of the largest JAX logit. At random init the eval
  logits are small (the batch norms' unit running variance meets
  activations far below it), so the limit is relative.

The training twin is ``tests/test_torch_mobilenet_train.py``.
"""
import functools

import numpy as np
import pytest
import torch

from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.vision import models as JM

from paddle_tpu_torch.vision import models as PM
from tests.torch_port_util import FP32_TOL, model_pair, sweep_close

FACTORIES = ("mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
             "mobilenet_v3_large")
#: state entries (parameters, then batch-norm buffers) and parameters
SIZES = {"mobilenet_v1": (137, 83), "mobilenet_v2": (262, 158),
         "mobilenet_v3_small": (210, 142), "mobilenet_v3_large": (266, 174)}


@functools.lru_cache(maxsize=None)
def _pair(factory, seed=3):
    """One pair a model for the module (the tests only read them: JAX's
    eager MobileNets take seconds to build and run on the CPU)."""
    return model_pair(lambda: getattr(JM, factory)(num_classes=10),
                      lambda device: getattr(PM, factory)(
                          num_classes=10, device=device), seed)


@pytest.mark.parametrize("factory", FACTORIES)
def test_module_tree_and_state_names_match_jax(factory):
    jm, tm = _pair(factory)
    jstate, tstate = jm.state_dict(), tm.state_dict()
    assert list(tstate) == list(jstate)
    assert [n for n, _ in tm.named_sublayers()] == [
        n for n, _ in jm.named_sublayers()]
    assert (len(tstate), len(tm.parameters())) == SIZES[factory]
    assert len(jm.parameters()) == SIZES[factory][1]
    for name, v in tstate.items():
        assert tuple(v.shape) == tuple(jstate[name].shape), name


@pytest.mark.parametrize("factory", FACTORIES)
def test_eval_logits_match_jax(factory):
    jm, tm = _pair(factory)
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    got = tm(torch.from_numpy(x))
    assert type(got) is torch.Tensor and tuple(got.shape) == (2, 10)
    want = np.asarray(jm(Tensor(x)).numpy())
    assert np.abs(want).max() > 0
    sweep_close(got.detach().numpy(), want, FP32_TOL, factory)


@pytest.mark.parametrize("kw", [{"scale": 0.5}, {"with_pool": False,
                                                 "num_classes": 0}])
def test_scale_and_headless_models_match_jax(kw):
    kw = dict(kw)
    num = kw.pop("num_classes", 10)
    jm, tm = model_pair(
        lambda: JM.mobilenet_v3_small(num_classes=num, **kw),
        lambda device: PM.mobilenet_v3_small(num_classes=num, device=device,
                                             **kw), 4)
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    want = np.asarray(jm(Tensor(x)).numpy())
    sweep_close(tm(torch.from_numpy(x)).detach().numpy(), want, FP32_TOL,
                str(kw))


@pytest.mark.parametrize("factory", FACTORIES)
def test_factories_refuse_pretrained_weights(factory):
    with pytest.raises(ValueError, match="download"):
        getattr(PM, factory)(pretrained=True, device="cpu")


def test_models_default_to_the_card():
    if not torch.cuda.is_available():
        for factory in FACTORIES:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                getattr(PM, factory)(num_classes=10)
