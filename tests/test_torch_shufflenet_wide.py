"""The wide ShuffleNetV2 factories (x1_0, x1_5, x2_0) against the JAX
package's on the CPU; the checks and limits of
``tests/test_torch_shufflenet.py``."""
import pytest

from tests.test_torch_shufflenet import check_factory


@pytest.mark.parametrize("factory", ["shufflenet_v2_x1_0",
                                     "shufflenet_v2_x1_5",
                                     "shufflenet_v2_x2_0"])
def test_eval_logits_and_state_match_jax(factory):
    check_factory(factory)
