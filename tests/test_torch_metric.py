"""The port's ``metric`` against the JAX package's on seeded predictions:
``accuracy``, ``Accuracy`` (top-k), ``Precision``, ``Recall`` and ``Auc``
compute in numpy in both, so the values are the same bits. And
``AsyncMetricBuffer``: one read back a drain, the last value."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.metric as jm
import paddle_tpu_torch.metric as pm
from tests.torch_port_util import port_cpu  # noqa: F401


def _preds(seed=0, n=50, classes=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, classes).astype(np.float32),
            rng.randint(0, classes, (n, 1)).astype(np.int64))


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_functional(k, port_cpu):
    pred, label = _preds()
    want = float(jm.accuracy(jp.to_tensor(pred), jp.to_tensor(label), k=k))
    got = pm.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
    assert float(got) == want


@pytest.mark.parametrize("topk", [(1,), (1, 2), (2, 5)])
def test_accuracy_metric_over_batches(topk, port_cpu):
    j, p = jm.Accuracy(topk=topk), pm.Accuracy(topk=topk, name="acc")
    for seed in range(3):
        pred, label = _preds(seed)
        jc = j.compute(jp.to_tensor(pred), jp.to_tensor(label))
        pc = p.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc._value))
        assert p.update(pc) == j.update(jc)
    assert p.accumulate() == j.accumulate()
    assert p.name() == j.name()
    # one-hot labels take the argmax, as in the JAX package
    pred, label = _preds(9)
    onehot = np.eye(5, dtype=np.float32)[label[:, 0]]
    np.testing.assert_array_equal(
        pm.Accuracy(topk=topk).compute(pred, onehot).numpy(),
        np.asarray(jm.Accuracy(topk=topk).compute(pred, onehot)._value))
    p.reset()
    assert p.accumulate() == (0.0 if len(topk) == 1 else [0.0] * len(topk))


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall(cls):
    j, p = getattr(jm, cls)(), getattr(pm, cls)()
    for seed in range(4):
        rng = np.random.RandomState(seed)
        preds = rng.rand(40).astype(np.float32)
        labels = rng.randint(0, 2, 40).astype(np.int64)
        j.update(jp.to_tensor(preds), jp.to_tensor(labels))
        p.update(torch.from_numpy(preds), labels)
    assert p.accumulate() == j.accumulate() and p.name() == j.name()


@pytest.mark.parametrize("num_thresholds", [4095, 200])
def test_auc(num_thresholds):
    j, p = jm.Auc(num_thresholds=num_thresholds), pm.Auc(
        num_thresholds=num_thresholds)
    for seed in range(3):
        rng = np.random.RandomState(seed)
        preds = rng.rand(64, 2).astype(np.float32)
        labels = (rng.rand(64) < preds[:, 1]).astype(np.int64)
        j.update(jp.to_tensor(preds), jp.to_tensor(labels))
        p.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert p.accumulate() == j.accumulate()
    np.testing.assert_array_equal(p._stat_pos, j._stat_pos)


def test_async_buffer_drains_in_one_read_back(monkeypatch):
    buf = pm.AsyncMetricBuffer()
    assert buf.last() is None and buf.drain() == []
    vals = [torch.tensor(v) for v in (1.5, 2.25)]
    vals.append(torch.tensor(3.0, dtype=torch.bfloat16))  # mixed types
    for v in vals:
        buf.append(v)
    buf.append(None)
    assert buf.num_pending == 3 and len(buf) == 3
    calls = []
    real_stack = torch.stack

    def stack(ts, *a, **k):
        calls.append(len(ts))
        return real_stack(ts, *a, **k)

    monkeypatch.setattr(torch, "stack", stack)
    assert buf.drain() == [1.5, 2.25, 3.0]
    assert calls == [3]  # one stacked copy for the three scalars
    assert buf.last() == 3.0 and buf.num_pending == 0
    buf.append(4.0)  # a host number too
    assert buf.result() == [1.5, 2.25, 3.0, 4.0]
    assert buf.values == [1.5, 2.25, 3.0, 4.0]


def test_async_buffer_telemetry_counts_fences():
    from paddle_tpu_torch.profiler import telemetry

    telemetry.reset()
    telemetry.enable()
    try:
        buf = pm.AsyncMetricBuffer()
        for v in (1.0, 2.0):
            buf.append(torch.tensor(v))
        buf.drain()
        c = telemetry.get_telemetry().counters()
        assert c["metric.fences"] == 1 and c["metric.scalars_read"] == 2
    finally:
        telemetry.disable()
        telemetry.reset()
