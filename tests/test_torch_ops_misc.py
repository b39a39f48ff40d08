"""The rest of the op sweep: the port's op table against the JAX package's
(``paddle_tpu/ops/op_table.py``), every op of the port's registry reached
by the table, the non-differentiable ops against the JAX package, a bf16
subset (elementwise ops and reductions) within one bf16 step of the largest
value, and the random ops (shapes, dtypes, ranges, moments and seeded
replay within the port: their draws are not the JAX package's)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.ops import op_table as jax_table

import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops import dispatch, op_table
from tests.torch_port_util import (jax_sweep_run, port_cpu,  # noqa: F401
                                   sweep_arrays, sweep_close, sweep_ids)

pytestmark = pytest.mark.usefixtures("port_cpu")


def test_the_port_table_copies_the_jax_tables_ops_entries():
    want = [(e["api"], e["inputs"], e["kwargs"], e["only"])
            for e in jax_table.OPS if e["api"].startswith("ops.")]
    got = [(e["api"], e["inputs"], e["kwargs"], e["only"])
           for e in op_table.OPS[:op_table.N_JAX]]
    assert got == want
    assert op_table.LOWP >= {k for k, v in jax_table.LOWP.items()
                             if v is False}


def test_every_registry_op_is_reached_by_the_table():
    with op_table.registry_ops_called() as called:
        for e in op_table.OPS + op_table.F_OPS + op_table.NONDIFF:
            op_table.run(e, sweep_arrays(e), paddle, "cpu")
    missing = sorted(set(dispatch.OP_REGISTRY) - called)
    assert missing == []
    assert len(dispatch.OP_REGISTRY) >= 160


@pytest.mark.parametrize("entry", op_table.NONDIFF,
                         ids=sweep_ids(op_table.NONDIFF))
def test_nondifferentiable_op_matches_jax(entry):
    arrays = sweep_arrays(entry)
    outs, grads = op_table.run(entry, arrays, paddle, "cpu")
    jouts, _ = jax_sweep_run(entry, arrays)
    assert grads is None
    tol = 1e-3 if entry["api"] in op_table.LINALG else 1e-6
    assert len(outs) == len(jouts)
    for i, (o, j) in enumerate(zip(outs, jouts)):
        # integer widths differ by design (ROADMAP.md C): compare values
        if np.asarray(j).dtype.kind in "iu":
            o = np.asarray(o).astype(np.int64)
            j = np.asarray(j).astype(np.int64)
        sweep_close(o, j, tol, f"{entry['api']} output {i}")


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_unique_matches_jax_with_every_output(axis):
    """``unique`` with its index, inverse and counts, over the whole tensor
    and along an axis, against the JAX package (``np.unique``); a bf16
    input gives the bf16 of the fp32 answer (the port computes it where
    the tensor lies, not through numpy)."""
    base = np.random.RandomState(2).randint(0, 3, (3, 4)).astype(np.float32)
    x = base[[0, 1, 0, 2, 1, 0]][:, [0, 1, 0, 2, 3, 1]]
    want = jp.unique(jp.to_tensor(x), True, True, True, axis=axis)
    got = paddle.unique(paddle.to_tensor(x), True, True, True, axis=axis)
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w.numpy()).reshape(-1))
    only = paddle.unique(paddle.to_tensor(x), axis=axis)
    np.testing.assert_array_equal(only.numpy(), want[0].numpy())
    low = paddle.unique(paddle.to_tensor(x).astype("bfloat16"), True, True,
                        True, axis=axis)
    assert low[0].dtype == torch.bfloat16
    for g, w in zip(low, got):
        np.testing.assert_array_equal(g.float().numpy(), w.numpy())


BF16 = [e for e in op_table.OPS[:op_table.N_JAX]
        if len(e["inputs"]) <= 2 and e["api"] not in op_table.LOWP
        and all(d in ("f", "fp", "f2", "funique", "unit", "gt1")
                for _, d in e["inputs"])
        and e["api"] not in ("ops.median", "ops.quantile", "ops.std",
                             "ops.var", "ops.cumprod", "ops.erfinv",
                             "ops.nextafter", "ops.trace", "ops.mv",
                             "ops.outer", "ops.kron", "ops.inner",
                             "ops.matmul", "ops.bmm", "ops.dot",
                             "ops.einsum_ij_jk", "ops.multi_dot",
                             "ops.addmm", "ops.cov")
        and e["api"][4:] in dir(paddle)]


def _bf16_step(x):
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.parametrize("entry", BF16, ids=sweep_ids(BF16))
def test_bf16_forward_within_a_bf16_step_of_jax(entry):
    # the inputs rounded to bf16 first, so both packages see the same bits
    arrays = [torch.from_numpy(a).bfloat16().float().numpy()
              if a.dtype == np.float32 else a for a in sweep_arrays(entry)]
    outs, _ = op_table.run(entry, arrays, paddle, "cpu", dtype="bfloat16")
    jouts, _ = jax_sweep_run(entry, arrays, dtype="bfloat16")
    for o, j in zip(outs, jouts):
        o, j = np.asarray(o, np.float64), np.asarray(j, np.float64)
        assert o.shape == j.shape
        assert np.abs(o - j).max() <= _bf16_step(j), entry["api"]


def test_bf16_subset_is_the_elementwise_ops_and_reductions():
    names = {e["api"] for e in BF16}
    assert {"ops.exp", "ops.add", "ops.sum", "ops.mean", "ops.max",
            "ops.logsumexp", "ops.cumsum"} <= names
    assert len(BF16) >= 40


# ----------------------------------------------------------- random ----

def _moments(t):
    v = t.numpy().astype(np.float64)
    return v.mean(), v.std()


def test_random_ops_shapes_dtypes_ranges_and_moments():
    paddle.seed(7)
    n = [200, 500]
    u = paddle.uniform(n, min=-2.0, max=3.0)
    assert u.shape == n and u.dtype == torch.float32
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    m, s = _moments(u)
    assert abs(m - 0.5) < 0.02 and abs(s - 5 / np.sqrt(12)) < 0.02
    r = paddle.rand(n, dtype="float64")
    assert r.dtype == torch.float64 and 0 <= float(r.min())
    m, s = _moments(paddle.randn(n))
    assert abs(m) < 0.01 and abs(s - 1) < 0.01
    m, s = _moments(paddle.normal(1.5, 0.5, n))
    assert abs(m - 1.5) < 0.01 and abs(s - 0.5) < 0.01
    m, s = _moments(paddle.standard_normal(n))
    assert abs(m) < 0.01 and abs(s - 1) < 0.01
    ri = paddle.randint(3, 9, n)
    assert ri.dtype == torch.int64 and 3 <= int(ri.min()) and \
        int(ri.max()) <= 8
    assert paddle.randint_like(ri, 0, 2).shape == n
    perm = paddle.randperm(50)
    assert sorted(perm.tolist()) == list(range(50))
    b = paddle.bernoulli(paddle.full(n, 0.3))
    assert abs(float(b.mean()) - 0.3) < 0.01
    p = paddle.poisson(paddle.full(n, 4.0))
    assert abs(float(p.mean()) - 4.0) < 0.05
    probs = paddle.to_tensor([[0.1, 0.0, 0.9]])
    mult = paddle.multinomial(probs, 1000, replacement=True)
    assert mult.shape == [1, 1000] and int((mult == 1).sum()) == 0
    assert abs(float((mult == 2).astype("float32").mean()) - 0.9) < 0.04
    t = paddle.zeros(n)
    t.uniform_(0.0, 1.0)
    t.normal_(2.0, 0.1)
    assert abs(_moments(t)[0] - 2.0) < 0.01
    t.exponential_(2.0)
    assert abs(_moments(t)[0] - 0.5) < 0.02
    bn = paddle.ops.random.binomial(paddle.full([1000], 10.0), paddle.full([1000], 0.5))
    assert bn.dtype == torch.int64 and abs(float(bn.astype(
        "float32").mean()) - 5.0) < 0.2


def test_random_ops_replay_under_one_seed():
    def draws():
        paddle.seed(11)
        return [paddle.rand([4]).numpy(), paddle.randn([3]).numpy(),
                paddle.randint(0, 100, [5]).numpy(),
                paddle.randperm(6).numpy(),
                paddle.uniform([2], seed=3).numpy()]

    a, b = draws(), draws()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    paddle.seed(12)
    assert not np.array_equal(paddle.rand([4]).numpy(), a[0])
    # JAX's draws are not the port's (a jax key split per draw)
    jp.seed(11)
    assert not np.allclose(jp.rand([4]).numpy(), a[0])


# ------------------------------------------------- the dispatcher's hooks ----

def test_amp_lists_cast_op_inputs_by_the_jax_op_name():
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    got, want = [], []
    for lib, out in ((paddle, got), (jp, want)):
        a = lib.to_tensor(x)
        with lib.amp.auto_cast(level="O1", dtype="bfloat16"):
            out.append(lib.matmul(a, a).dtype)          # white list
            out.append(lib.exp(a.astype("bfloat16")).dtype)   # black list
            out.append(lib.tanh(a).dtype)               # neither
        out.append(lib.matmul(a, a).dtype)              # outside
    assert [str(d).replace("torch.", "") for d in got] == [
        str(d) for d in want] == ["bfloat16", "float32", "float32",
                                  "float32"]


def test_check_nan_inf_flag_raises_on_a_non_finite_output():
    x = paddle.to_tensor([1.0, 0.0])
    paddle.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="divide"):
            paddle.divide(x, paddle.to_tensor([1.0, 0.0]))
        paddle.add(x, x)                                # finite: passes
    finally:
        paddle.set_flags({"check_nan_inf": False})
    assert bool(paddle.isnan(paddle.divide(x, x)).any())
