"""The op sweep, first half of the differentiable table
(``paddle_tpu_torch/ops/op_table.py``: the JAX table's ``ops.*`` entries
and the port's own): each op's forward and its gradient of ``sum(out *
c)``, the port on the CPU against the JAX package on the same seeded
inputs (fp32; limits in ``tests/torch_port_util.py``)."""
import pytest

from paddle_tpu_torch.ops.op_table import OPS
from tests.torch_port_util import port_cpu, sweep_check, sweep_ids  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

HALF = OPS[:len(OPS) // 2]


@pytest.mark.parametrize("entry", HALF, ids=sweep_ids(HALF))
def test_op_forward_and_gradient_match_jax(entry):
    sweep_check(entry)
