"""The port's ``profiler/devprof.py`` on the CPU: twins of the
``tests/test_devprof.py`` cases that have a meaning without XLA.

The JAX package reads its report from the compiled executable; the port
measures one real call of the step (``MemoryBreakdown.from_measured``,
``FlopCounterMode`` plus the kernels' Pallas estimates). Held here: the
memory identity and the hand-counted flops of the MLP step
(``tests/test_devprof.py:34``), the harvest on the first train step with
telemetry on and not again, a disabled harvest, the bubble arithmetic
against the JAX package's, the injected ``dispatch`` OOM (forensics on
stderr, the JSON round trip at ``OOM_DUMP_ENV``, "unavailable" before any
harvest, non-OOM errors passing through), the percentiles, the device
section and the gauges, ``DeviceStatsLogger`` and ``Model.device_report()``,
and each kernel's cost formula against the Pallas ``CostEstimate`` it
copies (``paddle_tpu/ops/pallas/flash_attention.py:382`` and ``:622``,
``flash_attention_packed.py:432``, ``fused_ce.py:229``). The JAX tests
without a counterpart are named in ``ROADMAP.md`` C.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.ops.cuda import cost as kcost
from paddle_tpu_torch.profiler import devprof, telemetry
from tests.torch_port_util import port_cpu  # noqa: F401

# hand count of the MLP step's products (batch 8, 16 -> 32 -> 4): both
# forwards, the second layer's dW and dX, the first layer's dW (x takes no
# gradient), 2 flops a multiply-add
MLP_FLOPS = 2 * (8 * 16 * 32 + 8 * 32 * 4 + 2 * 8 * 32 * 4 + 8 * 16 * 32)


def _mlp(seed=0):
    torch.manual_seed(seed)
    net = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.ReLU(),
                           pt.nn.Linear(32, 4))
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    return net, opt


def _mlp_step(name="train_step", seed=0):
    net, opt = _mlp(seed)

    def train_step(x, y):
        loss = F.cross_entropy(net(x), y).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    train_step.__name__ = name
    rng = np.random.RandomState(seed)
    x = pt.to_tensor(rng.rand(8, 16).astype(np.float32))
    y = pt.to_tensor(rng.randint(0, 4, (8, 1)).astype(np.int64))
    return train_step, x, y


def _model(seed=0):
    net, opt = _mlp(seed)
    model = pt.Model(net)
    model.prepare(opt, pt.nn.CrossEntropyLoss())
    rng = np.random.RandomState(seed)
    data = [(rng.rand(16).astype(np.float32),
             rng.randint(0, 4, (1,)).astype(np.int64)) for _ in range(24)]
    return model, data


def _fit(model, data, **kw):
    """Batches of 8 samples: the MLP step's ``(8, 16)``."""
    model.fit(data, batch_size=8, epochs=1, verbose=0, shuffle=False, **kw)


@pytest.fixture(autouse=True)
def _clean_registry(port_cpu):
    telemetry.disable()
    telemetry.reset()
    devprof.clear_reports()
    inject.disarm_all()
    yield
    inject.disarm_all()
    telemetry.disable()
    telemetry.reset()
    devprof.clear_reports()


# ---------------------------------------------------------------------------
# the report on the MLP step
# ---------------------------------------------------------------------------

def test_device_report_memory_breakdown_sums_to_peak():
    step, x, y = _mlp_step()
    rep = devprof.device_report(step, x, y)
    assert rep is devprof.get_report("train_step")
    assert rep is devprof.last_report()
    assert rep.flops == MLP_FLOPS      # FlopCounterMode, no kernel
    assert rep.bytes_accessed > 0
    md = rep.memory.as_dict()
    assert md["peak_bytes"] > 0
    assert (md["argument_bytes"] + md["output_bytes"] + md["temp_bytes"]
            + md["generated_code_bytes"] - md["alias_bytes"]
            == md["peak_bytes"])
    assert md["generated_code_bytes"] == 0
    # argument: the batch the step was handed (8 x 16 fp32 + 8 int64)
    assert md["argument_bytes"] == 8 * 16 * 4 + 8 * 8
    # single device: no interconnect traffic
    assert not rep.collectives
    assert rep.comm_bytes == 0
    assert rep.comm_fraction == 0.0
    assert "train_step" in rep.table()
    assert rep.kernels == {} and rep.uncounted_kernels == []


def test_memory_breakdown_from_measured_keeps_the_identity():
    for before, after, peak in ((100, 160, 400), (160, 100, 400),
                                (100, 100, 100), (50, 70, 10)):
        m = devprof.MemoryBreakdown.from_measured(before, after, peak)
        assert m.peak_bytes == max(before, after, peak)
        assert (m.argument_bytes + m.output_bytes + m.temp_bytes
                + m.generated_code_bytes - m.alias_bytes == m.peak_bytes)
        assert min(m.as_dict()[k] for k in ("argument_bytes", "output_bytes",
                                            "temp_bytes", "alias_bytes")) >= 0


def test_auto_harvest_on_first_train_step_registers_telemetry():
    telemetry.enable()
    model, data = _model()
    _fit(model, data)  # the first train step is measured
    rep = devprof.get_report(model.REPORT_NAME)
    assert rep is not None and rep is model.device_report()
    assert rep.flops == MLP_FLOPS
    g = telemetry.get_telemetry().gauges()
    assert g["hbm.peak_bytes"] == rep.memory.peak_bytes
    assert g["cost.flops"] == rep.flops
    assert g["comm.fraction"] == 0.0
    # the network's parameters are among the step's arguments
    params = sum(p.numel() * 4 for p in model.parameters())
    assert rep.memory.argument_bytes >= params
    # once per model: a second fit must not re-harvest
    devprof.clear_reports()
    _fit(model, data)
    assert devprof.get_report(model.REPORT_NAME) is None


def test_disabled_auto_harvest():
    telemetry.enable()
    devprof.enable_auto_harvest(False)
    try:
        model, data = _model()
        _fit(model, data)
        assert devprof.get_report(model.REPORT_NAME) is None
        assert model.device_report() is None
    finally:
        devprof.enable_auto_harvest(True)


def test_no_harvest_with_telemetry_off():
    model, data = _model()
    _fit(model, data)
    assert devprof.last_report() is None


# ---------------------------------------------------------------------------
# the kernels: Pallas estimates, no double count of their plain versions
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.fixture
def pallas_estimates(monkeypatch):
    """Record every ``pl.CostEstimate`` the JAX package builds and stop the
    call there (the Pallas kernel itself is not run)."""
    from jax.experimental import pallas as pl

    seen = []

    def record(**kw):
        seen.append({"flops": float(kw["flops"]),
                     "bytes_accessed": float(kw["bytes_accessed"]),
                     "transcendentals": float(kw["transcendentals"])})
        raise _Captured

    monkeypatch.setattr(pl, "CostEstimate", record)
    return seen


def _jax_estimate(seen, fn, *args, **kwargs):
    with pytest.raises(_Captured):
        fn(*args, **kwargs)
    return seen.pop()


def test_k1_cost_matches_the_pallas_estimate(pallas_estimates):
    import jax.numpy as jnp

    jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

    for causal in (True, False):
        shape = (1, 384, 3, 64)  # (b, s, h, d)
        q = np.random.RandomState(0).randn(*shape).astype(np.float32)
        want = _jax_estimate(pallas_estimates, jfa.flash_attention,
                             jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                             causal=causal, interpret=True)
        t = torch.from_numpy(q)
        assert kcost.ESTIMATES["K1"](t, t, t, None, causal) == want


def test_k4_cost_matches_the_pallas_estimate(pallas_estimates):
    import jax.numpy as jnp

    jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

    rng = np.random.RandomState(1)
    q = rng.randn(2, 128, 3, 64).astype(np.float32)
    kv = rng.randn(2, 384, 3, 64).astype(np.float32)
    pos = np.tile(np.arange(128, dtype=np.int32), (2, 1))
    want = _jax_estimate(pallas_estimates, jfa.flash_attention_cached,
                         jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                         jnp.asarray(pos), interpret=True)
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    assert kcost.ESTIMATES["K4"](tq, tkv, tkv, torch.from_numpy(pos)) == want


def test_k5_cost_matches_the_pallas_estimate(pallas_estimates):
    import jax.numpy as jnp

    jfp = importlib.import_module(
        "paddle_tpu.ops.pallas.flash_attention_packed")

    q = np.random.RandomState(2).randn(2, 256, 4 * 64).astype(np.float32)
    want = _jax_estimate(pallas_estimates, jfp.flash_attention_packed,
                         jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), 4,
                         causal=True, interpret=True)
    t = torch.from_numpy(q)
    assert kcost.ESTIMATES["K5"](t, t, t, 4, None, True) == want


@pytest.mark.parametrize("n,vocab", [(300, 1000), (2048, 512)])
def test_k9_cost_matches_the_pallas_estimate(pallas_estimates, n, vocab):
    import jax.numpy as jnp

    jce = importlib.import_module("paddle_tpu.ops.pallas.fused_ce")

    rng = np.random.RandomState(3)
    x = rng.randn(n, 128).astype(np.float32)
    w = rng.randn(vocab, 128).astype(np.float32)
    y = rng.randint(0, vocab, n).astype(np.int32)
    want = _jax_estimate(pallas_estimates, jce.ce_forward, jnp.asarray(x),
                         jnp.asarray(w), None, jnp.asarray(y), interpret=True)
    got = kcost.ESTIMATES["K9"](torch.from_numpy(x), torch.from_numpy(w),
                                None, torch.from_numpy(y))
    assert got == want


def test_kernels_without_a_pallas_estimate():
    assert sorted(kcost.ESTIMATES) == ["K1", "K4", "K5", "K9"]


def test_plain_versions_are_not_counted_twice():
    """K5's plain version runs as aten matmuls on the CPU; inside a harvest
    only its Pallas estimate counts, and K6 (its backward, no estimate) is
    listed as uncounted, as K7 and K8 are."""
    from paddle_tpu_torch.ops.cuda import flash_attention_packed as fp
    from paddle_tpu_torch.ops.cuda import layer_norm as ln

    rng = np.random.RandomState(4)
    b, s, h, d = 2, 64, 2, 32
    q, k, v = (torch.tensor(rng.randn(b, s, h * d).astype(np.float32),
                            requires_grad=True) for _ in range(3))
    g, bta = torch.ones(h * d, requires_grad=True), torch.zeros(h * d)

    def step(q, k, v):
        out = fp.flash_attention_packed(q, k, v, h, causal=True)
        ln.layer_norm(out, g, bta).sum().backward()

    rep = devprof.device_report(step, q, k, v, name="attn")
    want = kcost.ESTIMATES["K5"](q, k, v, h, None, True)["flops"]
    assert rep.flops == want == 4 * b * h * s * s * d * 0.5
    assert rep.kernels == {"K5 flash_attention_packed_fwd": 1}
    assert rep.uncounted_kernels == ["K6 flash_attention_packed_bwd",
                                     "K7 layer_norm", "K8 layer_norm_bwd"]
    assert rep.bytes_accessed >= kcost.ESTIMATES["K5"](
        q, k, v, h, None, True)["bytes_accessed"]
    assert "K6 flash_attention_packed_bwd" in rep.table()
    assert kcost._ACTIVE is None  # the harvest let go of its collector


# ---------------------------------------------------------------------------
# pipeline bubble (copied arithmetic, against the JAX package's)
# ---------------------------------------------------------------------------

def test_pipeline_bubble_fraction_analytic():
    from paddle_tpu.profiler import devprof as jdev

    assert devprof.pipeline_bubble_fraction(2, 2) == pytest.approx(1 / 3)
    assert devprof.pipeline_bubble_fraction(8, 4) == pytest.approx(3 / 11)
    assert devprof.pipeline_bubble_fraction(4, 1) == 0.0
    assert devprof.pipeline_bubble_fraction(0, 4) == 0.0
    for m, pp in ((1, 2), (3, 5), (16, 8)):
        assert devprof.pipeline_bubble_fraction(m, pp) == \
            jdev.pipeline_bubble_fraction(m, pp)


def test_bubble_from_synthetic_microbatch_spans():
    from paddle_tpu.profiler import devprof as jdev

    spans = {0: [(0.0, 1.0), (1.0, 2.0)], 1: [(1.0, 2.0), (2.0, 3.0)]}
    out = devprof.bubble_from_spans(spans)
    assert out["window_s"] == pytest.approx(3.0)
    assert out["per_rank"][0] == pytest.approx(1 / 3)
    assert out["per_rank"][1] == pytest.approx(1 / 3)
    assert out["bubble_fraction"] == pytest.approx(
        devprof.pipeline_bubble_fraction(2, 2))
    tuples = [(0, 0.0, 1.0), (0, 1.0, 2.0), (1, 1.0, 2.0), (1, 2.0, 3.0)]
    assert devprof.bubble_from_spans(tuples) == jdev.bubble_from_spans(tuples)
    assert devprof.bubble_from_spans({})["bubble_fraction"] == 0.0


# ---------------------------------------------------------------------------
# OOM forensics at hapi's dispatch point
# ---------------------------------------------------------------------------

def test_injected_dispatch_oom_dumps_forensics(capfd):
    telemetry.enable()
    model, data = _model()
    _fit(model, data[:8])  # harvest: forensics can cite the breakdown
    inject.arm("oom", "dispatch", at=1)  # the next dispatch
    with pytest.raises(Exception) as ei:
        _fit(model, data[:8])
    inject.disarm_all()
    # the original error is re-raised, not swallowed
    assert "RESOURCE_EXHAUSTED" in str(ei.value)
    assert devprof.is_oom_error(ei.value)
    fo = devprof.last_oom_report()
    assert fo is not None and fo.step_name == "train_step"
    err = capfd.readouterr().err
    assert "OOM forensics" in err
    assert "memory breakdown" in err
    assert "donation" in err
    d = fo.as_dict()
    assert d["memory"]["peak_bytes"] == model.device_report().memory.peak_bytes
    assert d["donation"] == {"donate_state": False, "donate_inputs": False,
                             "donate_paths": []}
    assert d["batch"] and d["batch"][0]["nbytes"] > 0
    assert d["state"] and d["state"][0]["nbytes"] >= d["state"][-1]["nbytes"]
    assert any(r["path"].startswith("state.network.") for r in d["state"])
    assert telemetry.get_telemetry().counters().get("oom.count") == 1


def test_oom_forensics_json_round_trip(tmp_path, monkeypatch, capfd):
    monkeypatch.setenv(devprof.OOM_DUMP_ENV, str(tmp_path))
    model, data = _model()
    inject.arm("oom", "dispatch", at=1)  # before any harvest: unavailable
    with pytest.raises(inject.InjectedResourceExhausted):
        _fit(model, data)
    inject.disarm_all()
    capfd.readouterr()
    path = tmp_path / "oom_train_step.json"
    assert path.exists()
    loaded = devprof.OOMForensics.from_dict(json.loads(path.read_text()))
    assert loaded.step_name == "train_step"
    assert loaded.memory is None
    assert tuple(loaded.batch[0]["shape"]) == (8, 16)
    assert "unavailable" in loaded.report()


def test_non_oom_dispatch_errors_pass_through():
    model, data = _model()
    inject.arm("error", "dispatch", at=1)
    with pytest.raises(inject.TransientError):
        _fit(model, data)
    inject.disarm_all()
    assert devprof.last_oom_report() is None or \
        "transient" not in devprof.last_oom_report().error


def test_cuda_oom_is_an_oom():
    assert devprof.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of "
                                                            "memory"))
    assert not devprof.is_oom_error(RuntimeError("shape mismatch"))


# ---------------------------------------------------------------------------
# telemetry surface: percentiles, device section, loader gauges
# ---------------------------------------------------------------------------

def test_phase_stats_percentiles_and_report_columns():
    telemetry.enable()
    tm = telemetry.get_telemetry()
    for i in range(20):
        tm.add_phase("dispatch", 0, (i + 1) * 1_000_000)  # 1..20 ms
    st = telemetry.summary()["phases"]["dispatch"]
    assert st["p50"] == pytest.approx(0.010, abs=2e-3)
    assert st["p95"] == pytest.approx(0.019, abs=2e-3)
    table = tm.report(file=open(os.devnull, "w"))
    assert "P50(ms)" in table and "P95(ms)" in table


def test_report_renders_device_stats_section():
    telemetry.enable()
    model, data = _model()
    _fit(model, data)
    table = telemetry.get_telemetry().report(file=open(os.devnull, "w"))
    assert "device stats:" in table
    assert "hbm.peak_bytes" in table


def test_device_loader_clears_gauges_on_shutdown():
    from paddle_tpu_torch.io import DeviceLoader

    telemetry.enable()
    loader = DeviceLoader([(np.zeros((2, 2), np.float32),)
                           for _ in range(3)], device="cpu")
    for _ in loader:
        pass
    assert "device_loader.queue_depth" not in \
        telemetry.get_telemetry().gauges()
    it = iter(loader)
    next(it)
    loader.shutdown()
    assert "device_loader.queue_depth" not in \
        telemetry.get_telemetry().gauges()


def test_export_scalars_includes_percentiles_and_device_gauges(tmp_path):
    from paddle_tpu_torch.utils.log_writer import LogWriter

    telemetry.enable()
    model, data = _model()
    _fit(model, data)
    with LogWriter(str(tmp_path), file_name="t.jsonl") as w:
        telemetry.get_telemetry().export_scalars(w, step=1)
    tags = {json.loads(line)["tag"]
            for line in (tmp_path / "t.jsonl").read_text().splitlines()}
    # the port's eager step is the dispatch phase (it compiles nothing)
    assert "telemetry/phase/dispatch/p50_s" in tags
    assert "telemetry/phase/dispatch/p95_s" in tags
    assert "telemetry/gauge/hbm.peak_bytes" in tags
    assert "telemetry/gauge/comm.fraction" in tags


# ---------------------------------------------------------------------------
# hapi surface
# ---------------------------------------------------------------------------

def test_hapi_device_stats_logger_callback(capsys, tmp_path):
    from paddle_tpu_torch.hapi.callbacks import DeviceStatsLogger

    torch.manual_seed(0)
    net = pt.nn.Linear(8, 4)
    model = pt.Model(net)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    model.prepare(opt, pt.nn.CrossEntropyLoss())
    rng = np.random.RandomState(0)
    data = [(rng.rand(4, 8).astype(np.float32),
             rng.randint(0, 4, (4, 1)).astype(np.int64))
            for _ in range(4)]
    cb = DeviceStatsLogger(log_dir=str(tmp_path))
    model.fit(data, epochs=1, verbose=0, callbacks=[cb])
    assert cb.report is not None
    assert cb.report.memory.peak_bytes > 0
    assert model.device_report() is cb.report
    assert "device cost report" in capsys.readouterr().out
    assert not telemetry.enabled()  # callback restored the flag
    tags = {json.loads(line)["tag"] for f in tmp_path.iterdir()
            for line in f.read_text().splitlines()}
    assert "telemetry/gauge/hbm.peak_bytes" in tags
    assert "telemetry/gauge/cost.flops" in tags
