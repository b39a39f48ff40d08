"""The op sweep of ``nn.functional`` (``paddle_tpu_torch/ops/op_table.py``'s
``F_OPS``: the JAX table's ``F.*`` entries whose functional the port has,
then the port's own): each functional's forward and its gradient of
``sum(out * c)``, the port on the CPU against the JAX package on the same
seeded inputs (fp32; limits in ``tests/torch_port_util.py``)."""
import pytest

from paddle_tpu.ops import op_table as jax_table

from paddle_tpu_torch.ops import op_table
from tests.torch_port_util import port_cpu, sweep_check, sweep_ids  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

#: the JAX table's ``F.*`` entries whose functional waits, by queue item
F_SWEEP_WAITING = {}


def test_the_port_table_copies_the_jax_tables_f_entries():
    want = [(e["api"], e["inputs"], e["kwargs"], e["only"])
            for e in jax_table.OPS if e["api"].startswith("F.")
            and e["api"] not in F_SWEEP_WAITING]
    got = [(e["api"], e["inputs"], e["kwargs"], e["only"])
           for e in op_table.F_OPS[:op_table.N_JAX_F]]
    assert got == want
    assert len(got) == 64
    jax_f = {e["api"] for e in jax_table.OPS if e["api"].startswith("F.")}
    assert set(F_SWEEP_WAITING) <= jax_f


@pytest.mark.parametrize("entry", op_table.F_OPS,
                         ids=sweep_ids(op_table.F_OPS))
def test_functional_forward_and_gradient_match_jax(entry):
    sweep_check(entry)
