"""The op sweep, second half of the differentiable table (see
``test_torch_ops_sweep_a.py``)."""
import pytest

from paddle_tpu_torch.ops.op_table import OPS
from tests.torch_port_util import port_cpu, sweep_check, sweep_ids  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

HALF = OPS[len(OPS) // 2:]


@pytest.mark.parametrize("entry", HALF, ids=sweep_ids(HALF))
def test_op_forward_and_gradient_match_jax(entry):
    sweep_check(entry)
