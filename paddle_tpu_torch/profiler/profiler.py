"""paddle.profiler — port of ``paddle_tpu/profiler/profiler.py`` on
``torch.profiler``.

Reference surface: ``python/paddle/profiler/profiler.py:271`` (class
Profiler, scheduler states ``:34``, ``make_scheduler:71``,
``export_chrome_tracing:158``) and ``profiler/utils.py:34`` (RecordEvent).

The JAX package keeps a host event recorder, the reference's scheduler
state machine, and chrome-trace export of the host spans, and captures the
device side with XLA's XPlane profiler. The port keeps the same three and
captures the device with ``torch.profiler.profile`` (CPU and, on a card,
CUDA activities, through CUPTI):

  * :class:`RecordEvent` is a host span; while a device capture runs it is
    also a ``torch.profiler.record_function``, so its name shows in the
    device trace (JAX: a ``jax.profiler.TraceAnnotation``);
  * a profiler whose targets name the card (``ProfilerTarget.GPU``, or
    ``TPU`` as its alias) runs the device capture during RECORD windows
    and writes its chrome trace, ``device_trace.json``, into a fresh
    temporary directory whose path takes the place of JAX's
    ``xplane_dir``;
  * the host spans, with the telemetry spans merged in, export as the
    JAX package's chrome JSON.

The JAX package's native host tracer (``core/native/host_tracer.cc``,
through ``core.load_native()``) is not ported: the port always takes the
Python path that JAX takes when ``core.load_native()`` gives None.
"""
from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
import time
from enum import Enum

__all__ = [
    "ProfilerState",
    "ProfilerTarget",
    "make_scheduler",
    "export_chrome_tracing",
    "export_protobuf",
    "Profiler",
    "RecordEvent",
    "load_profiler_result",
    "SortedKeys",
    "in_profiler_mode",
    "wrap_optimizers",
]

#: the device trace's file name inside a profiler's trace directory
DEVICE_TRACE = "device_trace.json"


class ProfilerState(Enum):
    """Reference ``profiler.py:34`` — profiling on/off state per step."""

    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    """Reference ``profiler.py:54`` (CPU/GPU/MLU) — here CPU (host spans)
    and GPU (the card's capture through ``torch.profiler``); TPU is
    accepted as an alias for the card, as the JAX package accepts GPU for
    its device."""

    CPU = 0
    GPU = 1
    TPU = 2


class SortedKeys(Enum):
    """Reference ``profiler_statistic.py`` SortedKeys."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """State machine over step numbers (reference ``profiler.py:71``):
    skip_first CLOSED steps, then cycles of closed→ready→record, the last
    record step returning RECORD_AND_RETURN."""
    period = closed + ready + record

    def getScheduleState(step: int) -> ProfilerState:
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat > 0 and step // period >= repeat:
            return ProfilerState.CLOSED
        pos = step % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return getScheduleState


def _default_state_scheduler(step: int):
    return ProfilerState.RECORD


# ---------------------------------------------------------------------------
# host event recording (≙ platform/profiler/host_tracer.cc)
# ---------------------------------------------------------------------------

_ACTIVE_PROFILERS = []


def in_profiler_mode():
    return bool(_ACTIVE_PROFILERS)


def _device_capture_running():
    return any(p._device_profile is not None for p in _ACTIVE_PROFILERS)


class _HostEvent:
    __slots__ = ("name", "event_type", "tid", "start_ns", "end_ns")

    def __init__(self, name, event_type, tid, start_ns, end_ns):
        self.name = name
        self.event_type = event_type
        self.tid = tid
        self.start_ns = start_ns
        self.end_ns = end_ns


class RecordEvent:
    """Host span annotation (reference ``profiler/utils.py:34`` RecordEvent ≙
    C++ ``platform::RecordEvent``). While a device capture runs it is also
    a ``torch.profiler.record_function``, so the name shows up inside the
    device trace."""

    def __init__(self, name: str, event_type: str = "PythonUserDefined"):
        self.name = name
        self.event_type = event_type
        self._start_ns = None
        self._torch_fn = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.end()

    def __call__(self, func):
        import functools

        @functools.wraps(func)
        def inner(*args, **kwargs):
            with RecordEvent(self.name, self.event_type):
                return func(*args, **kwargs)

        return inner

    def begin(self):
        if not in_profiler_mode():
            return
        if _device_capture_running():
            import torch

            self._torch_fn = torch.profiler.record_function(self.name)
            self._torch_fn.__enter__()
        self._start_ns = time.perf_counter_ns()

    def end(self):
        if self._start_ns is None:
            return
        end_ns = time.perf_counter_ns()
        if self._torch_fn is not None:
            self._torch_fn.__exit__(None, None, None)
            self._torch_fn = None
        start_ns = self._start_ns
        self._start_ns = None
        ev = _HostEvent(self.name, self.event_type, threading.get_ident(),
                        start_ns, end_ns)
        for prof in _ACTIVE_PROFILERS:
            prof._record(ev)


def wrap_optimizers():
    """Instrument Optimizer.step with a RecordEvent while profiling
    (reference ``profiler/utils.py:161``)."""
    from ..optimizer.optimizer import Optimizer

    if getattr(Optimizer, "_profiler_wrapped", False):
        return
    raw_step = Optimizer.step

    def step(self, *args, **kwargs):
        if in_profiler_mode():
            with RecordEvent(f"{type(self).__name__}.step", "Optimization"):
                return raw_step(self, *args, **kwargs)
        return raw_step(self, *args, **kwargs)

    Optimizer.step = step
    Optimizer._profiler_wrapped = True


# ---------------------------------------------------------------------------
# result container + exporters (≙ chrometracing_logger.cc / event_python.cc)
# ---------------------------------------------------------------------------

class ProfilerResult:
    """Host spans of a record window; ``xplane_dir`` (the JAX package's
    name) is the directory of the window's device trace
    (``device_trace.json``), or None."""

    def __init__(self, events, extra_info=None, xplane_dir=None):
        self.events = list(events)
        self.extra_info = dict(extra_info or {})
        self.xplane_dir = xplane_dir

    def save(self, path, format="json"):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if format == "json":
            data = {
                "traceEvents": [
                    {
                        "name": e.name,
                        "cat": e.event_type,
                        "ph": "X",
                        "pid": os.getpid(),
                        "tid": e.tid,
                        "ts": e.start_ns / 1e3,
                        "dur": (e.end_ns - e.start_ns) / 1e3,
                    }
                    for e in self.events
                ],
                "metadata": {"extra_info": self.extra_info,
                             "xplane_dir": self.xplane_dir},
            }
            with open(path, "w") as f:
                json.dump(data, f)
        else:
            raise ValueError(f"unsupported export format: {format}")


def load_profiler_result(filename: str):
    with open(filename) as f:
        data = json.load(f)
    events = [
        _HostEvent(e["name"], e.get("cat", ""), e.get("tid", 0),
                   int(e["ts"] * 1e3), int((e["ts"] + e["dur"]) * 1e3))
        for e in data.get("traceEvents", [])
    ]
    meta = data.get("metadata", {})
    return ProfilerResult(events, meta.get("extra_info"), meta.get("xplane_dir"))


def export_chrome_tracing(dir_name: str, worker_name: str = None):
    """on_trace_ready handler factory (reference ``profiler.py:158``)."""
    os.makedirs(dir_name, exist_ok=True)

    def handle_fn(prof):
        nonlocal worker_name
        if not worker_name:
            worker_name = f"host_{socket.gethostname()}pid{os.getpid()}"
        now = time.localtime()
        filename = "{}_time_{}.paddle_trace.json".format(
            worker_name, time.strftime("%Y_%m_%d_%H_%M_%S", now))
        if prof.profiler_result is not None:
            prof.profiler_result.save(os.path.join(dir_name, filename), "json")

    return handle_fn


def export_protobuf(dir_name: str, worker_name: str = None):
    """Reference ``profiler.py:209`` exports its own protobuf; the device
    trace is written by ``torch.profiler`` beside the host spans, which
    keep the chrome-json form."""
    return export_chrome_tracing(dir_name, worker_name)


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------

class Profiler:
    """Reference ``profiler.py:271``. ``targets`` containing GPU/TPU turns on
    the ``torch.profiler`` device capture during RECORD windows (CUDA
    activities on a card, the CPU's otherwise); CPU host spans are always
    collected while recording."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False):
        self.targets = list(targets) if targets else [ProfilerTarget.CPU,
                                                      ProfilerTarget.GPU]
        if scheduler is None:
            self.scheduler = _default_state_scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self.scheduler = make_scheduler(closed=max(start - 1, 0), ready=1,
                                            record=end - start, repeat=1)
        else:
            self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready or export_chrome_tracing(
            "profiler_log")
        self.timer_only = timer_only
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self.profiler_result = None
        self._events = []
        self._device_profile = None
        self._xplane_dir = None
        self._step_t0 = None
        self._step_times = []

    # -- host event sink --
    def _record(self, ev):
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._events.append(ev)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()

    def start(self):
        _ACTIVE_PROFILERS.append(self)
        wrap_optimizers()
        self.current_state = self.scheduler(self.step_num)
        self._maybe_toggle_device()
        self._step_t0 = time.perf_counter()

    def stop(self):
        if self in _ACTIVE_PROFILERS:
            _ACTIVE_PROFILERS.remove(self)
        if self._step_t0 is not None:
            # the in-flight step (started by start()/the last step()) ends
            # here — keep its duration so step_info() reflects the last step
            self._step_times.append(time.perf_counter() - self._step_t0)
            self._step_t0 = None
        self._stop_device()
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._finalize()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples=None):
        if self._step_t0 is not None:
            self._step_times.append(time.perf_counter() - self._step_t0)
        prev = self.current_state
        self.step_num += 1
        self.current_state = self.scheduler(self.step_num)
        if prev == ProfilerState.RECORD_AND_RETURN:
            self._stop_device()
            self._finalize()
            if self.on_trace_ready:
                self.on_trace_ready(self)
            self._events = []
        self._maybe_toggle_device()
        self._step_t0 = time.perf_counter()

    def step_info(self, unit=None):
        """Rolling last-10-step timing line; ``unit`` is one of
        ``'s'``/``'ms'``/``'us'`` (default ``'ms'``)."""
        if not self._step_times:
            return "no steps recorded"
        import numpy as np

        scale, suffix = {"s": (1.0, "s"), "ms": (1e3, "ms"),
                         "us": (1e6, "us")}.get(unit or "ms", (1e3, "ms"))
        arr = np.asarray(self._step_times[-10:]) * scale
        return (f"step {self.step_num}: avg {arr.mean():.3f} {suffix}, "
                f"max {arr.max():.3f} {suffix}, min {arr.min():.3f} {suffix}")

    # -- device capture (torch.profiler) --
    def _wants_device(self):
        return any(t in (ProfilerTarget.GPU, ProfilerTarget.TPU)
                   for t in self.targets)

    def _maybe_toggle_device(self):
        recording = self.current_state in (ProfilerState.RECORD,
                                           ProfilerState.RECORD_AND_RETURN)
        if not (recording and self._wants_device()
                and self._device_profile is None):
            return
        import torch

        if torch.autograd.profiler._is_profiler_enabled:
            return  # one torch.profiler session a process: leave it be
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._xplane_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_trace_")
        self._device_profile = torch.profiler.profile(activities=acts)
        self._device_profile.__enter__()

    def _stop_device(self):
        if self._device_profile is None:
            return
        prof, self._device_profile = self._device_profile, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(self._xplane_dir,
                                              DEVICE_TRACE))

    def _finalize(self):
        events = list(self._events)
        # pipeline telemetry spans (data_wait/h2d_copy/compile/dispatch/
        # readback, same perf_counter_ns clock) merge into the chrome trace
        from . import telemetry as _telemetry

        for name, s_ns, e_ns, tid in _telemetry.get_telemetry().chrome_spans():
            events.append(_HostEvent(f"telemetry::{name}", "Telemetry",
                                     tid, s_ns, e_ns))
        self.profiler_result = ProfilerResult(
            events,
            extra_info={"steps": self.step_num},
            xplane_dir=self._xplane_dir,
        )

    def export(self, path="", format="json"):
        if self.profiler_result is not None:
            self.profiler_result.save(path, format)

    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms"):
        """Aggregated host-span table (reference ``profiler.py:715`` →
        ``profiler_statistic._build_table``)."""
        events = (self.profiler_result.events
                  if self.profiler_result is not None else self._events)
        agg = {}
        for e in events:
            d = agg.setdefault(e.name, [0, 0.0, float("inf"), 0.0])
            dur = (e.end_ns - e.start_ns) / 1e6
            d[0] += 1
            d[1] += dur
            d[2] = min(d[2], dur)
            d[3] = max(d[3], dur)
        key_fn = {SortedKeys.CPUTotal: lambda d: d[1],
                  SortedKeys.CPUAvg: lambda d: d[1] / d[0],
                  SortedKeys.CPUMax: lambda d: d[3],
                  SortedKeys.CPUMin: lambda d: d[2],
                  SortedKeys.GPUTotal: lambda d: d[1],
                  SortedKeys.GPUAvg: lambda d: d[1] / d[0],
                  SortedKeys.GPUMax: lambda d: d[3],
                  SortedKeys.GPUMin: lambda d: d[2]}.get(
                      sorted_by, lambda d: d[1])
        rows = sorted(agg.items(), key=lambda kv: -key_fn(kv[1]))
        lines = [f"{'Name':<40} {'Calls':>6} {'Total(ms)':>12} "
                 f"{'Avg(ms)':>10} {'Min(ms)':>10} {'Max(ms)':>10}"]
        lines.append("-" * 92)
        for name, (cnt, tot, mn, mx) in rows:
            lines.append(f"{name[:40]:<40} {cnt:>6} {tot:>12.3f} "
                         f"{tot / cnt:>10.3f} {mn:>10.3f} {mx:>10.3f}")
        table = "\n".join(lines)
        print(table)
        return table


def get_profiler(config_path=None):
    return Profiler()
