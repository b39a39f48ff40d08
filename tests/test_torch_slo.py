"""The port's ``profiler/slo.py`` (a copy of the JAX package's) on the
port's telemetry registry: twins of ``tests/test_slo.py``, the scheduler's
inline checks through the port's ``Scheduler`` and ``default_slo_monitor``,
and ``TelemetryLogger``'s wiring through the port's ``Model.fit``.

Contracts under test:
  * spec grammar: bare gauges/counters, histogram percentile/mean stats,
    counter rates, per-spec objectives, parse errors on junk;
  * absent counters read as 0 (``fault.giveups == 0`` holds on a clean
    process) while absent histograms produce NO sample (no false pages);
  * burn-rate alerting: fires only when EVERY window exceeds its
    threshold, dedupes while firing, re-arms after recovery — all under
    an injected clock, no sleeping;
  * sinks: JSONL + callback, and a broken sink cannot break the check;
  * wiring: ``Scheduler(slo=)`` samples mid-serve, ``TelemetryLogger
    (slo=)`` samples per log_freq and prints the SLO table at train end.
"""
import json

import numpy as np
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu_torch.hapi.callbacks import TelemetryLogger
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.profiler import telemetry
from paddle_tpu_torch.profiler.slo import (
    SERVING_SLOS,
    JsonlAlertSink,
    SLOMonitor,
    SLOSpec,
    log_alert_sink,
)
from paddle_tpu_torch.serving import (GenerationEngine, Request, Scheduler,
                                      default_slo_monitor)
from tests.torch_port_util import port_cpu  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


# ---------------------------------------------------------------------------
# spec parsing + evaluation
# ---------------------------------------------------------------------------
def test_spec_parse_forms():
    s = SLOSpec.parse("serve.latency_s p95 < 0.5")
    assert (s.metric, s.stat, s.op, s.threshold) \
        == ("serve.latency_s", "p95", "<", 0.5)
    assert s.objective is None
    s = SLOSpec.parse("fault.giveups == 0")
    assert (s.metric, s.stat, s.op, s.threshold) \
        == ("fault.giveups", None, "==", 0.0)
    s = SLOSpec.parse("serve.decode_steps rate > 1.5 @ 0.999")
    assert (s.stat, s.objective) == ("rate", 0.999)
    s = SLOSpec.parse("phase.data_wait mean <= 0.01")
    assert (s.metric, s.stat) == ("phase.data_wait", "mean")


@pytest.mark.parametrize("bad", [
    "no operator here", "metric !! 3", "m < notanumber",
    "m p95 < 0.5 @ 7", "", "m bogus < 1",
])
def test_spec_parse_errors(bad):
    with pytest.raises(ValueError):
        SLOSpec.parse(bad)


def test_spec_evaluation_against_registry():
    tm = telemetry.get_telemetry()
    tm.set_gauge("serve.queue_depth", 3)
    tm.inc("serve.evicted", 12)
    for v in (0.1, 0.4):
        tm.observe("serve.latency_s", v)

    ok, v = SLOSpec.parse("serve.queue_depth < 16").evaluate(tm)
    assert (ok, v) == (True, 3.0)
    ok, v = SLOSpec.parse("serve.evicted >= 12").evaluate(tm)
    assert (ok, v) == (True, 12.0)
    ok, v = SLOSpec.parse("serve.latency_s p95 < 0.2").evaluate(tm)
    assert (ok, v) == (False, 0.4)
    # absent counter reads 0 (clean-process semantics)
    ok, v = SLOSpec.parse("fault.giveups == 0").evaluate(tm)
    assert (ok, v) == (True, 0.0)
    # absent histogram: no sample, not a page
    ok, v = SLOSpec.parse("serve.ttft_s p95 < 1").evaluate(tm)
    assert (ok, v) == (None, None)


def test_counter_rate_stat():
    tm = telemetry.get_telemetry()
    spec = SLOSpec.parse("serve.tokens_generated rate > 10")
    state = {}
    assert spec.value(tm, rate_state=state, now=0.0) is None  # first read
    tm.inc("serve.tokens_generated", 50)
    assert spec.value(tm, rate_state=state, now=2.0) == pytest.approx(25.0)
    tm.inc("serve.tokens_generated", 5)
    assert spec.value(tm, rate_state=state, now=3.0) == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# burn-rate monitor
# ---------------------------------------------------------------------------
def _monitor(specs, windows=((10.0, 5.0), (60.0, 2.0)), objective=0.9,
             sinks=()):
    return SLOMonitor(specs, objective=objective, windows=windows,
                      sinks=list(sinks), clock=lambda: 0.0)


def test_alert_fires_only_when_all_windows_burn():
    tm = telemetry.get_telemetry()
    tm.set_gauge("serve.queue_depth", 100)  # violates from the start
    alerts = []
    mon = _monitor(["serve.queue_depth < 16"], sinks=[alerts.append])
    # budget = 0.1, constant violation → burn 10x in both windows once
    # enough samples exist; single alert, deduped while firing
    for t in range(20):
        mon.check(now=float(t))
    assert len(alerts) == 1
    a = alerts[0]
    assert a["spec"] == "serve.queue_depth < 16"
    assert a["value"] == 100.0
    assert all(w["burn_rate"] >= w["max_burn"] for w in a["windows"])
    assert mon.status()[0]["firing"]

    # recovery: the gauge drops, the short window clears first, monitor
    # re-arms, a later sustained violation pages AGAIN
    tm.set_gauge("serve.queue_depth", 2)
    for t in range(20, 120):
        mon.check(now=float(t))
    assert not mon.status()[0]["firing"]
    tm.set_gauge("serve.queue_depth", 200)
    for t in range(120, 240):
        mon.check(now=float(t))
    assert len(alerts) == 2


def test_short_blip_does_not_page():
    """One violating sample inside an otherwise-clean stream must not
    fire: the long window keeps its burn under threshold."""
    tm = telemetry.get_telemetry()
    alerts = []
    mon = SLOMonitor(["serve.queue_depth < 16"], objective=0.5,
                     windows=((5.0, 1.5), (60.0, 1.5)),
                     sinks=[alerts.append], clock=lambda: 0.0)
    tm.set_gauge("serve.queue_depth", 1)
    for t in range(60):
        if t == 30:
            tm.set_gauge("serve.queue_depth", 99)  # one-tick blip
        mon.check(now=float(t))
        if t == 30:
            tm.set_gauge("serve.queue_depth", 1)
    assert alerts == []


def test_jsonl_sink_and_sink_isolation(tmp_path):
    tm = telemetry.get_telemetry()
    tm.set_gauge("serve.queue_depth", 50)
    path = tmp_path / "alerts.jsonl"

    def broken_sink(alert):
        raise RuntimeError("sink down")

    mon = _monitor(["serve.queue_depth < 16"],
                   sinks=[broken_sink, JsonlAlertSink(str(path))])
    with pytest.warns(RuntimeWarning, match="sink.*failed"):
        for t in range(10):
            mon.check(now=float(t))
    rows = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["value"] == 50.0


def test_log_sink_warns():
    tm = telemetry.get_telemetry()
    tm.set_gauge("serve.queue_depth", 50)
    mon = _monitor(["serve.queue_depth < 16"], sinks=[log_alert_sink])
    with pytest.warns(RuntimeWarning, match="SLO burn"):
        for t in range(10):
            mon.check(now=float(t))


def test_report_table(capsys):
    tm = telemetry.get_telemetry()
    tm.set_gauge("serve.queue_depth", 2)
    mon = _monitor(["serve.queue_depth < 16", "fault.giveups == 0"])
    for t in range(5):
        mon.check(now=float(t))
    table = mon.report()
    capsys.readouterr()
    assert "serve.queue_depth < 16" in table
    assert "fault.giveups == 0" in table
    assert "100.0%" in table  # fully compliant
    assert "FIRING" not in table


# ---------------------------------------------------------------------------
# wiring: scheduler + TelemetryLogger
# ---------------------------------------------------------------------------
def test_scheduler_checks_slo_inline(port_cpu):
    import torch

    torch.manual_seed(0)
    model = GPTForCausalLM(GPTConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
        max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0), device="cpu")
    model.eval()
    eng = GenerationEngine(model, max_batch=2, max_len=64,
                           prefill_buckets=(8,))
    alerts = []
    # impossible objective so the run itself pages: latency p95 < 0 with
    # single-sample windows
    mon = SLOMonitor(["serve.latency_s p95 < 0"], objective=0.9,
                     windows=((3600.0, 1.0),), sinks=[alerts.append])
    sched = Scheduler(eng, slo=mon, slo_check_every=1)
    rng = np.random.RandomState(0)
    for _ in range(3):
        sched.submit(Request(prompt=rng.randint(0, 97, 4).tolist(),
                             max_new_tokens=3))
    sched.run()
    assert mon.checks >= sched.decode_steps  # sampled every tick + drain
    assert len(alerts) == 1
    assert alerts[0]["metric"] == "serve.latency_s"


def test_default_slo_monitor_ships_the_serving_slos():
    import paddle_tpu.profiler.slo as jslo
    from paddle_tpu.serving import default_slo_monitor as jdefault

    mon = default_slo_monitor(objective=0.95)
    assert [s.name for s in mon.specs] == list(SERVING_SLOS) \
        == list(jslo.SERVING_SLOS)
    assert [s.name for s in jdefault().specs] == [s.name for s in mon.specs]
    assert mon.objective == 0.95
    assert all(s.stat in ("rate", "p95") for s in mon.specs)


def test_telemetry_logger_slo_wiring(capsys, port_cpu):
    class _DS:
        def __init__(self, n=48):
            rng = np.random.RandomState(0)
            self.x = rng.randn(n, 8).astype(np.float32)
            self.y = (self.x.sum(1) > 0).astype(np.int64)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

        def __len__(self):
            return len(self.x)

    paddle.seed(0)
    net = paddle.nn.Sequential(paddle.nn.Linear(8, 2))
    model = paddle.Model(net)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
    model.prepare(opt, CrossEntropyLoss())
    alerts = []
    mon = SLOMonitor(["phase.dispatch p95 < 0", "fault.giveups == 0"],
                     objective=0.9, windows=((3600.0, 1.0),),
                     sinks=[alerts.append])
    cb = TelemetryLogger(log_freq=1, print_report=True, slo=mon)
    model.fit(_DS(), batch_size=16, epochs=1, verbose=0, callbacks=[cb])
    assert cb.slo_monitor is mon
    assert mon.checks >= 3  # one per batch at log_freq=1, plus train end
    assert alerts and alerts[0]["metric"] == "phase.dispatch"
    out = capsys.readouterr().out
    assert "phase.dispatch p95 < 0" in out  # SLO table printed at end
    assert "fault.giveups == 0" in out
    assert "FIRING" in out


def test_telemetry_logger_slo_from_strings():
    """Spec strings build a monitor lazily at train begin."""
    cb = TelemetryLogger(print_report=False, slo=["fault.giveups == 0"])
    assert cb.slo_monitor is None
    cb.on_train_begin()
    assert isinstance(cb.slo_monitor, SLOMonitor)
    assert cb.slo_monitor.specs[0].metric == "fault.giveups"
    cb.on_train_end()
