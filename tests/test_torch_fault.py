"""The port's fault tolerance (twins of ``tests/test_fault_tolerance.py``):
atomic saves and corrupt files, ``CheckpointManager``'s latest pointer,
pruning and verified fallback, the preemption guard, ``DeviceLoader``'s
transient-stage retry, a killed worker's restart, ``Model.fit(resume=...)``
checkpoints, ``ModelCheckpoint``'s final alias and pruning, and
kill-and-resume reproducing the uninterrupted run bit for bit within the
port (SGD shuffled, Adam fp16 with fp32 masters, and a dropout-0.1 GPT that
draws from every generator ``TrainState`` keeps), the uninterrupted curves
held to the JAX package's. A ``CheckpointManager`` directory the JAX
package wrote restores in the port's ``ResumeSession``."""
import os
import signal
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name
from paddle_tpu_torch.fault import (CheckpointManager, PreemptionGuard,
                                    ResumeSession, TrainingPreempted,
                                    TransientError, inject)
from paddle_tpu_torch.framework.io import CheckpointCorruptError
from paddle_tpu_torch.framework.io import load as pload
from paddle_tpu_torch.framework.io import save as psave
from paddle_tpu_torch.io import DataLoader, DeviceLoader
from paddle_tpu_torch.io.worker import WorkerFailure
from tests.torch_port_util import (FP32_TOL, jax_state,  # noqa: F401
                                   no_persistent_compile_cache, port_cpu)


@pytest.fixture(autouse=True)
def _clean_injection(monkeypatch):
    # fork-start for the worker test and a disarmed injection registry
    # around every test, in both packages
    import paddle_tpu.fault.inject as jinject

    monkeypatch.setenv("PADDLE_TPU_WORKER_START", "fork")
    inject.disarm_all()
    jinject.disarm_all()
    yield
    inject.disarm_all()
    jinject.disarm_all()


# -- framework.io atomicity + corruption detection --------------------------

def test_save_is_atomic_and_roundtrips(tmp_path, port_cpu):
    path = str(tmp_path / "sub" / "state.pdparams")
    psave({"w": pt.to_tensor(np.arange(6, dtype=np.float32))}, path)
    assert os.listdir(os.path.dirname(path)) == ["state.pdparams"]
    out = pload(path, return_numpy=True)
    np.testing.assert_array_equal(out["w"], np.arange(6, dtype=np.float32))


def test_load_truncated_and_garbage_raise_corrupt_error(tmp_path):
    path = str(tmp_path / "t.pdparams")
    psave({"w": np.arange(1024, dtype=np.float32)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointCorruptError, match="t.pdparams"):
        pload(path)
    path = str(tmp_path / "g.pdparams")
    with open(path, "wb") as f:
        f.write(b"\x80\x04this is not a pickle at all")
    with pytest.raises(CheckpointCorruptError) as ei:
        pload(path)
    assert ei.value.path == path and ei.value.__cause__ is not None


# -- CheckpointManager ---------------------------------------------------------

def test_manager_roundtrip_latest_pointer_and_pruning(tmp_path, port_cpu):
    m = CheckpointManager(str(tmp_path / "ck"), keep_last_n=3)
    for s in range(1, 6):
        m.save(s, {"model": {"w": np.full(4, float(s), np.float32)},
                   "cursor": {"epoch": s}})
    assert m.steps() == [3, 4, 5]
    assert m.latest_step() == 5
    step, payloads = m.load()
    assert step == 5
    assert isinstance(payloads["model"]["w"], pt.Tensor)
    np.testing.assert_array_equal(payloads["model"]["w"].numpy(),
                                  np.full(4, 5.0))
    assert payloads["cursor"]["epoch"] == 5
    assert m.verify(4) == []
    # the JAX package's manager reads the same directory
    import paddle_tpu.fault as jfault

    jstep, jpay = jfault.CheckpointManager(str(tmp_path / "ck")).load()
    assert jstep == 5 and jpay["cursor"] == {"epoch": 5}


def test_manager_torn_write_detected_and_falls_back(tmp_path, port_cpu):
    from paddle_tpu_torch.profiler import telemetry

    m = CheckpointManager(str(tmp_path / "ck"))
    m.save(7, {"model": {"w": np.zeros(64, np.float32)}})
    inject.arm("torn", "ckpt.write", at=1)
    m.save(8, {"model": {"w": np.ones(64, np.float32)}})
    assert m.verify(8), "torn write must fail verification"
    telemetry.reset()
    telemetry.enable()
    try:
        with pytest.warns(UserWarning, match="recovered from corrupt"):
            step, payloads = m.load()
        assert step == 7
        assert telemetry.get_telemetry().counters()[
            "fault.ckpt_recoveries"] == 1
    finally:
        telemetry.disable()
        telemetry.reset()


def test_manager_all_corrupt_raises_and_empty_dir_is_none(tmp_path):
    m = CheckpointManager(str(tmp_path / "ck"))
    m.save(1, {"model": {"w": np.ones(16, np.float32)}})
    with open(os.path.join(m.step_dir(1), "model.pdparams"), "r+b") as f:
        f.truncate(4)
    with pytest.warns(UserWarning):
        with pytest.raises(CheckpointCorruptError, match="no verifiable"):
            m.load()
    assert CheckpointManager(str(tmp_path / "nothing")).load() is None


def test_injection_fires_deterministically():
    for _ in range(2):
        inject.disarm_all()
        inject.arm("error", "stage", at=3)
        fired = []
        for i in range(6):
            try:
                inject.check("stage")
            except TransientError:
                fired.append(i)
        assert fired == [2]


def test_preemption_guard_latches_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.preempted
        signal.raise_signal(signal.SIGTERM)
        assert g.preempted
    assert signal.getsignal(signal.SIGTERM) is prev


# -- DeviceLoader transient-stage retry ---------------------------------------

def test_device_loader_retries_transient_stage_error():
    inject.arm("error", "stage", at=2)
    batches = [(np.full((2, 2), i, np.float32),) for i in range(4)]
    out = list(DeviceLoader(batches, device="cpu"))
    assert len(out) == 4  # the injected failure was absorbed by retry
    np.testing.assert_array_equal(out[1][0].numpy(), np.ones((2, 2)))


def test_device_loader_nontransient_stage_error_propagates():
    def batches():
        yield (np.ones(2, np.float32),)
        raise ValueError("source bug")

    with pytest.raises(ValueError, match="source bug"):
        list(DeviceLoader(batches(), device="cpu"))


def test_device_loader_telemetry():
    from paddle_tpu_torch.profiler import telemetry

    telemetry.reset()
    telemetry.enable()
    try:
        batches = [(np.ones((4, 2), np.float32),) for _ in range(3)]
        assert len(list(DeviceLoader(batches, device="cpu"))) == 3
        tm = telemetry.get_telemetry()
        c = tm.counters()
        assert c["device_loader.batches_staged"] == 3
        assert c["device_loader.bytes_staged"] == 3 * 32
        assert c["device_loader.prefetch_hit"] == 3
        assert tm.stat("phase.h2d_copy", "count") == 3
        assert tm.stat("phase.data_wait", "count") == 3
        assert not any(k.startswith("device_loader.") for k in tm.gauges())
    finally:
        telemetry.disable()
        telemetry.reset()


# -- worker death: restart + re-dispatch --------------------------------------

class ArrayDS(pt.io.Dataset):
    def __init__(self, n=32):
        self.x = np.arange(n, dtype=np.float32)

    def __getitem__(self, i):
        return (self.x[i],)

    def __len__(self):
        return len(self.x)


def test_killed_worker_restarts_and_epoch_completes(tmp_path, monkeypatch,
                                                    port_cpu):
    once = str(tmp_path / "kill_once")
    monkeypatch.setenv(inject.ENV_VAR, f"kill:worker.fetch:2:{once}")
    inject.reload_env()
    loader = DataLoader(ArrayDS(), batch_size=4, num_workers=2,
                        use_process=True, worker_restart_limit=2)
    got = sorted(float(v) for b in loader for v in b[0].numpy().ravel())
    assert got == [float(i) for i in range(32)]
    assert os.path.exists(once)
    # without a restart budget the same kill fails the epoch
    monkeypatch.setenv(inject.ENV_VAR,
                       f"kill:worker.fetch:2:{tmp_path / 'kill_once_0'}")
    inject.reload_env()
    with pytest.raises(WorkerFailure, match="exited unexpectedly"):
        list(DataLoader(ArrayDS(), batch_size=4, num_workers=2,
                        use_process=True, worker_restart_limit=0))


def test_workers_killed_while_idle_are_replaced_with_their_queues(port_cpu):
    """Every worker SIGKILLed while idle in the task queue's get (one of
    them holds its cross-process reader lock): the pool replaces the
    workers and both queues, and the epoch completes with every sample
    once. Respawning only the dead slots on the old queues (the JAX
    package's recovery) leaves the new workers waiting on the dead one's
    lock; ``timeout`` turns that into a failure rather than a hang."""
    import time

    loader = DataLoader(ArrayDS(8), batch_size=1, num_workers=2,
                        use_process=True, persistent_workers=True,
                        worker_restart_limit=2, timeout=20)
    it = iter(loader)
    got = [float(next(it)[0].numpy()[0])]
    time.sleep(0.5)  # the issued tasks are done; both workers wait in get
    for p in loader._pool._procs:
        os.kill(p.pid, signal.SIGKILL)
    got += [float(b[0].numpy()[0]) for b in it]
    assert sorted(got) == [float(i) for i in range(8)]
    loader.__del__()


# -- kill-and-resume -------------------------------------------------------------

class _Toy:
    def __init__(self, n=48, seed=0, dtype=np.float32):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 8).astype(dtype)
        w = rng.randn(8).astype(np.float32)
        self.y = (self.x.astype(np.float32) @ w > 0).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class JToy(_Toy, jp.io.Dataset):
    pass


class PToy(_Toy, pt.io.Dataset):
    pass


def _recorder(pkg):
    class LossRecorder(pkg.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    return LossRecorder()


def _jax_state():
    with unique_name.guard():
        jp.seed(0)
        net = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.ReLU(),
                               jp.nn.Linear(16, 2))
    return jax_state(net)


def _make_model(pkg, optimizer, dtype=None):
    """A toy model of ``pkg`` from the JAX package's seed-0 weights."""
    if pkg is jp:
        with unique_name.guard():
            jp.seed(0)
            net = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.ReLU(),
                                   jp.nn.Linear(16, 2))
    else:
        net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                               pt.nn.Linear(16, 2))
        pt.models.load_jax_state(net, _jax_state())
    if dtype:
        net.to(dtype=dtype)
    model = pkg.Model(net)
    model.prepare(optimizer(pkg, net), pkg.nn.CrossEntropyLoss())
    return model


def _sgd(pkg, net):
    return pkg.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())


def _adam_masters(pkg, net):
    return pkg.optimizer.Adam(learning_rate=0.05, parameters=net.parameters(),
                              multi_precision=True)


def _parity_run(tmp_path, make, data, fit_kw, kill_at):
    """Uninterrupted run vs (SIGTERM-killed + resumed) run of the port:
    the losses bitwise equal, step for step. Returns the uninterrupted
    curve."""
    np.random.seed(1234)
    ref = _recorder(pt)
    make().fit(data(), callbacks=[ref], **fit_kw)

    ck = str(tmp_path / "resume_ck")
    np.random.seed(1234)
    part1 = _recorder(pt)
    inject.arm("sigterm", "train.step", at=kill_at)
    with pytest.raises(TrainingPreempted):
        make().fit(data(), callbacks=[part1], resume=ck, **fit_kw)
    inject.disarm_all()
    assert len(part1.losses) == kill_at
    # a fresh process stand-in: a brand-new model/optimizer, state from
    # disk; the generators are scrambled first, the checkpoint restores them
    np.random.seed(99)
    torch.manual_seed(99)
    pt.seed(99)
    part2 = _recorder(pt)
    make().fit(data(), callbacks=[part2], resume=ck, **fit_kw)
    resumed = part1.losses + part2.losses
    assert len(resumed) == len(ref.losses)
    assert resumed == ref.losses  # BITWISE: float equality, no tolerance
    return ref.losses


def _jax_curve(optimizer, data, fit_kw, dtype=None):
    np.random.seed(1234)
    ref = _recorder(jp)
    _make_model(jp, optimizer, dtype).fit(data(), callbacks=[ref], **fit_kw)
    return ref.losses


FIT_KW = dict(batch_size=8, epochs=2, verbose=0, log_freq=1)


def test_kill_and_resume_loss_parity_sgd_shuffled(
        tmp_path, port_cpu, no_persistent_compile_cache):
    kw = dict(FIT_KW, shuffle=True)
    curve = _parity_run(tmp_path, lambda: _make_model(pt, _sgd), PToy, kw,
                        kill_at=8)
    np.testing.assert_allclose(curve, _jax_curve(_sgd, JToy, kw),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_kill_and_resume_loss_parity_adam_master_weights(
        tmp_path, port_cpu, no_persistent_compile_cache):
    kw = dict(FIT_KW, shuffle=False)
    data = lambda cls: (lambda: cls(dtype=np.float16))  # noqa: E731
    curve = _parity_run(tmp_path,
                        lambda: _make_model(pt, _adam_masters, "float16"),
                        data(PToy), kw, kill_at=7)
    want = _jax_curve(_adam_masters, data(JToy), kw, "float16")
    # the loss is an fp16 log-softmax and mean in both packages, rounded in
    # other orders (XLA:CPU against PyTorch's CPU kernels): within two fp16
    # steps of the loss (the fp32 curve above is held to 1e-5)
    np.testing.assert_allclose(curve, want, rtol=2.0 ** -9, atol=0)


class Tokens(pt.io.Dataset):
    def __init__(self, n=24, seq=9, vocab=31):
        self.ids = np.random.RandomState(3).randint(0, vocab, (n, seq))

    def __getitem__(self, i):
        return self.ids[i, :-1], self.ids[i, 1:]

    def __len__(self):
        return len(self.ids)


def test_kill_and_resume_is_bitwise_at_dropout_0_1(tmp_path, port_cpu):
    """GPT at dropout 0.1: hidden dropout draws from PyTorch's global
    generator, attention dropout from the port's, so a generator left out
    of ``TrainState`` changes the resumed losses."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    def make():
        pt.seed(0)  # every generator, as a fresh process's script would
        net = GPTForCausalLM(GPTConfig(
            vocab_size=31, hidden_size=16, num_layers=1, num_heads=2,
            max_position_embeddings=16, hidden_dropout=0.1,
            attention_dropout=0.1), device="cpu")
        model = pt.Model(net)
        model.prepare(pt.optimizer.SGD(learning_rate=0.5,
                                       parameters=net.parameters()),
                      pt.nn.CrossEntropyLoss())
        return model

    _parity_run(tmp_path, make, Tokens,
                dict(FIT_KW, batch_size=4, shuffle=True), kill_at=5)


def test_fit_resume_writes_epoch_and_periodic_checkpoints(tmp_path, port_cpu):
    ck = str(tmp_path / "ck")
    model = _make_model(pt, _sgd)
    model.fit(PToy(), batch_size=8, epochs=2, verbose=0, shuffle=False,
              resume=ck, ckpt_freq=2, keep_last_n=3)
    mgr = CheckpointManager(ck)
    steps = mgr.steps()
    assert steps and len(steps) <= 3
    _, payloads = mgr.load()
    assert payloads["cursor"]["epoch"] == 2
    assert set(payloads["rng"]["torch"]) >= {"seed", "port_cpu", "torch_cpu"}
    again = _recorder(pt)
    _make_model(pt, _sgd).fit(PToy(), batch_size=8, epochs=2, verbose=0,
                              shuffle=False, resume=ck, callbacks=[again])
    assert again.losses == []


def test_jax_checkpoint_restores_in_the_port(tmp_path, port_cpu,
                                             no_persistent_compile_cache):
    """The JAX package's fit(resume=...) is killed at step 7 (Adam fp16 with
    fp32 masters, a StepDecay schedule): the port's ResumeSession restores
    its parameters, accumulators with masters, schedule, cursor and host
    RNG, and skips the jax key with one warning."""
    import paddle_tpu.fault as jfault

    def opt(pkg, net):
        return pkg.optimizer.Adam(
            learning_rate=pkg.optimizer.lr.StepDecay(0.05, step_size=3,
                                                     gamma=0.5),
            parameters=net.parameters(), multi_precision=True)

    ck = str(tmp_path / "jax_ck")
    np.random.seed(1234)
    jfault.inject.arm("sigterm", "train.step", at=7)
    with pytest.raises(jfault.TrainingPreempted):
        _make_model(jp, opt, "float16").fit(
            JToy(dtype=np.float16), resume=ck, **dict(FIT_KW, shuffle=True))
    jfault.inject.disarm_all()
    _, want = jfault.CheckpointManager(ck).load()

    model = _make_model(pt, opt, "float16")
    sess = ResumeSession(ck, model.network, model._optimizer)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cursor = sess.restore()
    sess.close()
    assert [str(w.message) for w in caught
            if "jax PRNG key" in str(w.message)] and len(caught) == 1
    # 6 steps an epoch: killed after the first step of the second
    assert cursor == (1, 1) == (want["cursor"]["epoch"],
                                want["cursor"]["step"])
    assert sess.global_step == 7
    for name, v in model.network.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want["model"][name]))
    got = model._optimizer.state_dict()
    jopt = want["optimizer"]
    assert got["@step"] == jopt["@step"]
    assert got["LR_Scheduler"] == dict(jopt["LR_Scheduler"])
    assert model._optimizer.get_lr() == 0.05 * 0.5 ** 2  # 7 steps of 3
    for k, v in jopt.items():
        if k in ("@step", "LR_Scheduler"):
            continue
        np.testing.assert_array_equal(
            np.asarray(got[k].float()).reshape(-1),
            np.asarray(v, np.float32).reshape(-1), err_msg=k)
    assert any(k.endswith("master_weight") for k in got)
    host = want["rng"]["host_epoch_start"]["np"]
    np.testing.assert_array_equal(np.random.get_state()[1], np.asarray(host[1]))


# -- ModelCheckpoint: final aliasing + keep_last_n ------------------------------

def _fit_with_ckpt(tmp_path, epochs, save_freq, keep_last_n=None):
    model = _make_model(pt, _sgd)
    d = str(tmp_path / "mc")
    mc = pt.callbacks.ModelCheckpoint(save_freq, d, keep_last_n=keep_last_n)
    model.fit(PToy(32), batch_size=16, epochs=epochs, verbose=0,
              callbacks=[mc])
    return d


def test_model_checkpoint_final_alias(tmp_path, port_cpu):
    d = _fit_with_ckpt(tmp_path / "a", epochs=2, save_freq=1)
    assert os.path.samefile(os.path.join(d, "final.pdparams"),
                            os.path.join(d, "1.pdparams"))
    d = _fit_with_ckpt(tmp_path / "b", epochs=2, save_freq=2)
    assert not os.path.samefile(os.path.join(d, "final.pdparams"),
                                os.path.join(d, "0.pdparams"))


def test_model_checkpoint_keep_last_n_prunes(tmp_path, port_cpu):
    d = _fit_with_ckpt(tmp_path, epochs=4, save_freq=1, keep_last_n=2)
    present = sorted(f for f in os.listdir(d) if f.endswith(".pdparams"))
    assert present == ["2.pdparams", "3.pdparams", "final.pdparams"]
