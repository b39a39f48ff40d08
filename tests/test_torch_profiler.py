"""The port's ``paddle.profiler`` (``paddle_tpu_torch/profiler/profiler.py``,
on ``torch.profiler``): twins of ``tests/test_profiler.py`` — the scheduler
state machine against the JAX package's, RecordEvent off outside a
profiler, a captured train step, the chrome round trip, the summary by
average, stop mid-step, nested save directories, ``step_info`` units —
and the device capture on the CPU (the card's is in
``tests/test_torch_cuda_kernels.py``)."""
import glob
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from paddle_tpu.profiler import ProfilerState as JState
from paddle_tpu.profiler import make_scheduler as jax_make_scheduler

import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler
from paddle_tpu_torch.profiler import (
    Profiler, ProfilerState, ProfilerTarget, RecordEvent, SortedKeys,
    export_chrome_tracing, load_profiler_result, make_scheduler,
)
from tests.torch_port_util import port_cpu  # noqa: F401


def _states(sched, n):
    return [sched(i).name for i in range(n)]


def test_make_scheduler_states():
    sched = make_scheduler(closed=1, ready=1, record=4, repeat=1, skip_first=1)
    states = [sched(i) for i in range(9)]
    assert states[0] == ProfilerState.CLOSED          # skip_first
    assert states[1] == ProfilerState.CLOSED
    assert states[2] == ProfilerState.READY
    assert states[3:6] == [ProfilerState.RECORD] * 3
    assert states[6] == ProfilerState.RECORD_AND_RETURN
    assert states[7] == ProfilerState.CLOSED          # repeat exhausted
    assert states[8] == ProfilerState.CLOSED
    # the same machine as the JAX package's, state for state
    for kw in (dict(closed=1, ready=1, record=4, repeat=1, skip_first=1),
               dict(closed=2, ready=0, record=3, repeat=0, skip_first=2),
               dict(closed=0, ready=2, record=1, repeat=3)):
        assert _states(make_scheduler(**kw), 40) == \
            _states(jax_make_scheduler(**kw), 40), kw
    assert [s.name for s in ProfilerState] == [s.name for s in JState]


def test_record_event_noop_outside_profiler():
    ev = RecordEvent("nothing")
    ev.begin()
    ev.end()  # must not raise, must not record
    assert ev._start_ns is None and ev._torch_fn is None
    assert not profiler.in_profiler_mode()


def test_profiler_captures_train_step(port_cpu):
    traces = []

    def on_ready(prof):
        traces.append(prof.profiler_result)

    lin = pt.nn.Linear(8, 8)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    x = pt.to_tensor(np.random.randn(4, 8).astype(np.float32))

    prof = Profiler(targets=[ProfilerTarget.CPU],
                    scheduler=make_scheduler(closed=0, ready=1, record=2,
                                             repeat=1),
                    on_trace_ready=on_ready)
    prof.start()
    for i in range(4):
        with RecordEvent("train_step"):
            loss = lin(x).square().mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        prof.step()
    prof.stop()

    assert traces, "on_trace_ready never fired"
    names = [e.name for e in traces[0].events]
    assert "train_step" in names
    assert any(n.endswith(".step") for n in names), \
        f"optimizer span missing: {names}"
    # summary builds a table over captured spans
    table = prof.summary()
    assert "train_step" in table


def test_chrome_export_roundtrip(tmp_path):
    out = str(tmp_path / "traces")
    prof = Profiler(targets=[ProfilerTarget.CPU],
                    on_trace_ready=export_chrome_tracing(out, worker_name="w0"))
    with prof:
        with RecordEvent("span_a"):
            time.sleep(0.001)
    files = glob.glob(os.path.join(out, "w0*.json"))
    assert files
    result = load_profiler_result(files[0])
    assert any(e.name == "span_a" for e in result.events)
    data = json.load(open(files[0]))
    assert data["traceEvents"][0]["ph"] == "X"
    # the loaded events are the saved ones
    saved = prof.profiler_result.events
    assert [(e.name, e.start_ns // 1000) for e in result.events] == \
        [(e.name, e.start_ns // 1000) for e in saved]


def test_context_manager_with_step_range_scheduler():
    with Profiler(targets=[ProfilerTarget.CPU], scheduler=(1, 3),
                  on_trace_ready=lambda p: None) as prof:
        for _ in range(4):
            with RecordEvent("w"):
                pass
            prof.step()
    assert prof.step_num == 4
    assert "step" in prof.step_info()


# ---------------------------------------------------------------------------
# make_scheduler state-machine edges
# ---------------------------------------------------------------------------

def test_make_scheduler_skip_first_only_delays_the_cycle():
    sched = make_scheduler(closed=2, ready=1, record=1, skip_first=3)
    assert [sched(i) for i in range(3)] == [ProfilerState.CLOSED] * 3
    assert sched(3) == ProfilerState.CLOSED
    assert sched(4) == ProfilerState.CLOSED
    assert sched(5) == ProfilerState.READY
    assert sched(6) == ProfilerState.RECORD_AND_RETURN


def test_make_scheduler_single_step_record_window():
    sched = make_scheduler(closed=0, ready=0, record=1, repeat=2)
    assert sched(0) == ProfilerState.RECORD_AND_RETURN
    assert sched(1) == ProfilerState.RECORD_AND_RETURN
    assert sched(2) == ProfilerState.CLOSED  # repeat exhausted


def test_make_scheduler_repeat_exhaustion_stays_closed():
    sched = make_scheduler(closed=1, ready=0, record=2, repeat=2, skip_first=1)
    period = 3
    for i in range(1 + 2 * period, 1 + 2 * period + 10):
        assert sched(i) == ProfilerState.CLOSED
    sched0 = make_scheduler(closed=1, ready=0, record=2, repeat=0)
    assert sched0(3 * 1000 + 2) == ProfilerState.RECORD_AND_RETURN


def test_make_scheduler_negative_step_raises():
    sched = make_scheduler(closed=1, ready=1, record=1)
    with pytest.raises(ValueError):
        sched(-1)
    with pytest.raises(ValueError):
        jax_make_scheduler(closed=1, ready=1, record=1)(-1)


# ---------------------------------------------------------------------------
# summary sort, stop() in-flight step, save dirs, units
# ---------------------------------------------------------------------------

def _profiler_with_events(events):
    from paddle_tpu_torch.profiler.profiler import _HostEvent

    prof = Profiler(targets=[ProfilerTarget.CPU],
                    on_trace_ready=lambda p: None)
    prof._events = [_HostEvent(name, "PythonUserDefined", 0, s, e)
                    for name, s, e in events]
    return prof


def test_summary_sorted_by_avg_uses_per_call_average(capsys):
    ms = 1_000_000
    events = [("A", 0, 10 * ms)]
    events += [("B", i * 20 * ms, i * 20 * ms + 12 * ms // 10)
               for i in range(1, 11)]
    prof = _profiler_with_events(events)
    by_total = prof.summary(sorted_by=SortedKeys.CPUTotal)
    by_avg = prof.summary(sorted_by=SortedKeys.CPUAvg)
    capsys.readouterr()

    def first_row_name(table):
        return table.splitlines()[2].split()[0]

    assert first_row_name(by_total) == "B"  # 12ms total beats 10ms
    assert first_row_name(by_avg) == "A"    # 10ms avg beats 1.2ms


def test_profiler_stop_keeps_inflight_step_duration():
    prof = Profiler(targets=[ProfilerTarget.CPU],
                    on_trace_ready=lambda p: None)
    prof.start()
    time.sleep(0.002)
    prof.step()
    time.sleep(0.002)
    prof.stop()  # the in-flight step must not be dropped
    assert len(prof._step_times) == 2
    assert all(t >= 0.002 for t in prof._step_times)
    assert "step" in prof.step_info()


def test_profiler_result_save_creates_nested_dirs(tmp_path):
    from paddle_tpu_torch.profiler.profiler import ProfilerResult, _HostEvent

    res = ProfilerResult([_HostEvent("x", "t", 0, 0, 1000)])
    target = tmp_path / "deeply" / "nested" / "dir" / "trace.json"
    res.save(str(target))  # must not throw on the missing parents
    assert target.exists()
    assert load_profiler_result(str(target)).events[0].name == "x"


def test_step_info_honors_unit():
    prof = Profiler(targets=[ProfilerTarget.CPU],
                    on_trace_ready=lambda p: None)
    prof._step_times = [0.5]
    assert "500.000 ms" in prof.step_info()
    assert "0.500 s" in prof.step_info(unit="s")
    assert "500000.000 us" in prof.step_info(unit="us")


# ---------------------------------------------------------------------------
# the device capture (torch.profiler), on the CPU's activities here
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", [ProfilerTarget.GPU, ProfilerTarget.TPU])
def test_device_target_writes_a_torch_trace_with_record_event_names(target):
    x = torch.randn(16, 16)
    with Profiler(targets=[ProfilerTarget.CPU, target],
                  on_trace_ready=lambda p: None) as prof:
        with RecordEvent("device_span"):
            (x @ x).sum()
    res = prof.profiler_result
    assert res.xplane_dir and os.path.isdir(res.xplane_dir)
    trace = json.load(open(os.path.join(res.xplane_dir,
                                        profiler.profiler.DEVICE_TRACE)))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "device_span" in names   # record_function inside the capture
    assert "aten::mm" in names
    assert any(e.name == "device_span" for e in res.events)  # host span
    assert not torch.autograd.profiler._is_profiler_enabled
    shutil.rmtree(res.xplane_dir)
