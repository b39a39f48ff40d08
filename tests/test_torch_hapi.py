"""The port's hapi ``Model`` against the JAX package's (twins of
``tests/test_hapi_model.py``): the same seeded weights
(``models.load_jax_state``) and the same ``np.random.seed`` go into both,
and ``fit`` over two shuffled epochs gives the same loss at every fence
within 1e-5 and the same accuracy; ``evaluate``/``predict`` and the batch
calls agree; ``.pdparams``/``.pdopt`` files cross between the packages in
both directions; the callbacks, ``summary``/``flops`` on LeNet, prepare's
type errors and the ``NotImplementedError``s of the arguments that wait for
an unported package."""
import contextlib
import io
import os

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name
from tests.torch_port_util import (FP32_TOL, default_place,  # noqa: F401
                                   jax_state, no_persistent_compile_cache,
                                   port_cpu)


class _Toy:
    """Linearly separable 2-class problem (``test_hapi_model._ToyClassify``)."""

    def __init__(self, n=64, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 8).astype(np.float32)
        w = rng.randn(8).astype(np.float32)
        self.y = (self.x @ w > 0).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class JToy(_Toy, jp.io.Dataset):
    pass


class PToy(_Toy, pt.io.Dataset):
    pass


def _jax_net():
    with unique_name.guard():
        jp.seed(0)
        return jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.ReLU(),
                                jp.nn.Linear(16, 2))


def _port_net(state):
    net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                           pt.nn.Linear(16, 2))
    pt.models.load_jax_state(net, state)
    return net


def _models(opt="Adam", lr=0.1, metrics=True, sched=None):
    """``(jax_model, port_model)`` prepared alike from the same weights."""
    jnet = _jax_net()
    state = jax_state(jnet)
    out = []
    for pkg, net in ((jp, jnet), (pt, _port_net(state))):
        lr_ = sched(pkg) if sched else lr
        o = getattr(pkg.optimizer, opt)(learning_rate=lr_,
                                        parameters=net.parameters())
        m = pkg.Model(net)
        m.prepare(o, pkg.nn.CrossEntropyLoss(),
                  pkg.metric.Accuracy() if metrics else None)
        out.append(m)
    return out


def _recorder(pkg, rows):
    class Rec(pkg.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            rows.append((logs.get("loss"), logs.get("acc")))

    return Rec()


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=FP32_TOL, atol=FP32_TOL)


def test_fit_matches_jax_at_every_fence(port_cpu, no_persistent_compile_cache):
    jm, pm = _models()
    runs = []
    for pkg, m, ds in ((jp, jm, JToy), (pt, pm, PToy)):
        rows = []
        np.random.seed(5)
        logs = m.fit(ds(), batch_size=16, epochs=2, verbose=0, log_freq=2,
                     callbacks=[_recorder(pkg, rows)])
        runs.append((rows, logs))
    (jrows, jlogs), (prows, plogs) = runs
    assert len(prows) == len(jrows) == 8
    for (pl, pa), (jl, ja) in zip(prows, jrows):
        _close(pl, jl)
        assert pa == ja  # the same batches in the same order
    _close(plogs["loss"], jlogs["loss"])
    assert plogs["acc"] == jlogs["acc"] and plogs["acc"] > 0.8


def test_evaluate_and_predict_match_jax(port_cpu, no_persistent_compile_cache):
    jm, pm = _models()
    for m, ds in ((jm, JToy), (pm, PToy)):
        np.random.seed(2)
        m.fit(ds(), batch_size=16, epochs=2, verbose=0)
    jev = jm.evaluate(JToy(32, seed=1), batch_size=16, verbose=0)
    pev = pm.evaluate(PToy(32, seed=1), batch_size=16, verbose=0)
    assert pev["eval_samples"] == jev["eval_samples"] == 32
    _close(pev["loss"], jev["loss"])
    assert pev["acc"] == jev["acc"]
    for stack in (True, False):
        jp_ = jm.predict(JToy(32, seed=1), batch_size=16,
                         stack_outputs=stack, verbose=0)
        pp = pm.predict(PToy(32, seed=1), batch_size=16,
                        stack_outputs=stack, verbose=0)
        assert len(pp) == len(jp_) == 1
        _close(np.concatenate(pp[0]) if not stack else pp[0],
               np.concatenate(jp_[0]) if not stack else jp_[0])
    assert pp[0][0].shape == (16, 2)


def test_train_and_eval_batch_match_jax(port_cpu, no_persistent_compile_cache):
    jm, pm = _models()
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    y = np.zeros((16,), np.int64)
    for _ in range(2):
        (jl,), (pl,) = jm.train_batch([x], [y]), pm.train_batch([x], [y])
        _close(pl, jl)
    _close(pm.eval_batch([x], [y])[0], jm.eval_batch([x], [y])[0])
    _close(pm.predict_batch([x])[0], jm.predict_batch([x])[0])
    assert pm._metrics[0].accumulate() == jm._metrics[0].accumulate()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pdparams_pdopt_cross_packages(direction, tmp_path, port_cpu,
                                       no_persistent_compile_cache):
    """One package trains and saves; a fresh model of the other loads the
    files and takes the next step: the same loss and the same predictions
    as the saver's own next step (the Adam moments crossed too)."""
    jm, pm = _models()
    src, dst = (jm, pm) if direction == "jax_to_port" else (pm, jm)
    x = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    for _ in range(3):
        src.train_batch([x], [y])
    path = str(tmp_path / "ck" / "m")
    src.save(path)
    assert os.path.exists(path + ".pdparams") and os.path.exists(path + ".pdopt")
    fresh_j, fresh_p = _models(lr=0.1)
    fresh = fresh_p if dst is pm else fresh_j
    fresh.load(path)
    _close(fresh.predict_batch([x])[0], src.predict_batch([x])[0])
    _close(fresh.train_batch([x], [y])[0], src.train_batch([x], [y])[0])
    _close(fresh.predict_batch([x])[0], src.predict_batch([x])[0])


def test_model_checkpoint_callback(tmp_path, port_cpu):
    _, pm = _models()
    save_dir = str(tmp_path / "auto")
    pm.fit(PToy(32), batch_size=16, epochs=2, verbose=0, save_dir=save_dir,
           save_freq=1)
    assert os.path.exists(os.path.join(save_dir, "0.pdparams"))
    assert os.path.exists(os.path.join(save_dir, "final.pdparams"))
    # the JAX package reads the port's files
    state = jp.load(os.path.join(save_dir, "final.pdparams"))
    assert set(state) == {"0.weight", "0.bias", "2.weight", "2.bias"}


def test_early_stopping_stops(port_cpu):
    _, pm = _models(lr=0.0)  # frozen -> the metric never improves
    es = pt.callbacks.EarlyStopping(monitor="loss", patience=1, verbose=0,
                                    save_best_model=False)
    epochs = []

    class CountEpochs(pt.callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            epochs.append(epoch)

    pm.fit(PToy(32), eval_data=PToy(16, seed=2), batch_size=16, epochs=10,
           verbose=0, callbacks=[es, CountEpochs()])
    assert len(epochs) < 10, "early stopping never fired"


def test_lr_scheduler_callback_steps_as_jax(port_cpu,
                                            no_persistent_compile_cache):
    lrs = []
    models = _models(opt="SGD", metrics=False, sched=lambda pkg: (
        pkg.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2,
                                   gamma=0.5)))
    for m, ds in zip(models, (JToy, PToy)):
        m.fit(ds(48), batch_size=16, epochs=1, verbose=0, shuffle=False)
        lrs.append(m._optimizer._learning_rate.last_lr)
    # 3 steps an epoch, step_size 2 -> one decay, in both
    assert lrs[1] == lrs[0] == 0.05


def test_summary_and_flops_of_lenet_match_jax(port_cpu):
    from paddle_tpu.vision.models import LeNet as JLeNet

    from paddle_tpu_torch.vision.models import LeNet as PLeNet

    out = []
    for pkg, lenet in ((jp, JLeNet), (pt, PLeNet)):
        f = io.StringIO()
        with contextlib.redirect_stdout(f):
            info = pkg.summary(lenet(), (1, 1, 28, 28))
            n = pkg.flops(lenet(), [1, 1, 28, 28], print_detail=True)
        out.append((info, n, f.getvalue()))
    assert out[1] == out[0]
    assert out[1][0] == {"total_params": 61610, "trainable_params": 61610}
    assert "Conv2D (features.0)                     [1, 6, 28, 28]" in out[1][2]
    _, pm = _models()
    assert pm.summary((4, 8))["total_params"] == 178


def test_prepare_type_errors(port_cpu):
    net = pt.nn.Sequential(pt.nn.Linear(8, 2))
    model = pt.Model(net)
    with pytest.raises(TypeError):
        model.prepare(None, loss=123)
    with pytest.raises(TypeError):
        model.prepare(None, pt.nn.CrossEntropyLoss(), metrics=[object()])
    with pytest.raises(RuntimeError):
        model.train_batch([np.zeros((2, 8), np.float32)],
                          [np.zeros(2, np.int64)])
    with pytest.raises(TypeError):
        pt.Model(object())


def test_unported_packages_raise_by_name(port_cpu):
    net = pt.nn.Sequential(pt.nn.Linear(8, 2))
    model = pt.Model(net)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    loss = pt.nn.CrossEntropyLoss()
    for kw, item in (({"zero": "dp"}, "A8"), ({"remat": "auto"}, "A9"),
                     ({"graph_lint": True}, "A9")):
        with pytest.raises(NotImplementedError, match=item):
            model.prepare(opt, loss, **kw)
    model.prepare(opt, loss, graph_lint=False, zero=None, remat=None)
    model.prepare(opt, loss, graph_lint=None)
    assert model.device_report() is None  # no train step harvested yet
    cb = pt.hapi.callbacks.DeviceStatsLogger(print_report=False)
    rng = np.random.RandomState(0)
    model.fit([(rng.rand(4, 8).astype(np.float32),
                rng.randint(0, 2, (4, 1)).astype(np.int64))],
              epochs=1, verbose=0, callbacks=[cb])
    assert model.device_report() is cb.report
    assert cb.report.memory.peak_bytes > 0 and cb.report.flops > 0
    with pytest.raises(NotImplementedError, match="A10"):
        model.prepare(opt, loss, remat=1 << 30)


def test_model_runs_on_the_current_place_only(port_cpu, monkeypatch):
    import torch

    _, pm = _models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with default_place():  # gpu:0, and no card
        for call in (lambda: pm.fit(PToy(16), batch_size=8, verbose=0),
                     lambda: pm.evaluate(PToy(16), batch_size=8, verbose=0),
                     lambda: pm.predict(PToy(16), batch_size=8, verbose=0),
                     lambda: pm.train_batch([np.zeros((2, 8), np.float32)],
                                            [np.zeros(2, np.int64)])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_synthetic_mnist_is_learnable_in_one_epoch(port_cpu):
    """``chip_smoke.py``'s hapi_lenet data at a small size on the CPU: one
    epoch of 1,280 images (20 steps at batch 64) brings LeNet's eval top-1
    accuracy to ``LENET_MIN_ACC``, the bar the card's 60,000 must clear."""
    import torch

    import chip_smoke
    from paddle_tpu_torch.vision.models import LeNet

    x, y = chip_smoke.synthetic_mnist(np, 0, 1280)
    tx, ty = chip_smoke.synthetic_mnist(np, 1, 320)
    assert x.shape == (1280, 1, 28, 28) and x.dtype == np.float32
    assert y.shape == (1280, 1) and set(np.unique(y)) == set(range(10))
    torch.manual_seed(3)
    net = LeNet(num_classes=10)
    model = pt.Model(net)
    model.prepare(pt.optimizer.Adam(learning_rate=1e-3,
                                    parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss(), pt.metric.Accuracy(topk=(1, 2)))
    np.random.seed(5)
    model.fit(pt.io.TensorDataset([x, y]), batch_size=64, epochs=1,
              verbose=0)
    ev = model.evaluate(pt.io.TensorDataset([tx, ty]), batch_size=64,
                        verbose=0)
    assert ev["acc_top1"] >= chip_smoke.LENET_MIN_ACC, ev
