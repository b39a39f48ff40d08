"""Device-side observability: per-step cost, memory and OOM forensics —
port of ``paddle_tpu/profiler/devprof.py``.

The JAX package reads its figures from the compiled executable
(``memory_analysis()``, ``cost_analysis()``, the optimized HLO) without
running the step. Eager PyTorch has no such executable, so the port
measures one real call of the step:

* :class:`MemoryBreakdown` keeps JAX's identity ``peak = argument + output
  + temp + generated_code − alias``. On the card ``argument`` is what the
  caching allocator holds when the step starts
  (``torch.cuda.memory_stats``' ``allocated_bytes.all.current``),
  ``output`` what it holds when the step ends, ``alias`` the smaller of
  the two (the buffers the step updates in place are counted once, as
  JAX counts donated ones), ``temp`` the measured peak
  (``allocated_bytes.all.peak`` after ``reset_peak_memory_stats``) above
  the larger, and ``generated_code`` 0. On the CPU ``argument`` is the
  bytes of the tensors handed to the step (a ``Layer``'s parameters and
  buffers included) and the rest comes from ``torch.profiler``'s memory
  record of the call (its operators' allocations in start order; 0 when
  another profiler is already running).
* :class:`DeviceCostReport` — ``flops`` are what
  ``torch.utils.flop_counter.FlopCounterMode`` counts of the aten
  operations plus, for the hand-written kernels, their Pallas
  counterparts' ``CostEstimate`` (:mod:`paddle_tpu_torch.ops.cuda.cost`);
  the kernels launched without an estimate are listed by name
  (``uncounted_kernels``). ``bytes_accessed`` counts, as XLA's cost
  analysis does, each aten operation's operand and result bytes (views
  move none), plus the kernels' estimates.
* :class:`CollectiveStats` — kept with JAX's fields; it stays empty, since
  the port runs on one device.
* :func:`device_report` runs a step once under measurement; with
  telemetry on, hapi ``Model``'s train step harvests its first call
  (:class:`Harvest`). Reports go to the process registry
  (:func:`get_report`, :func:`last_report`) and, with telemetry on, into
  its ``hbm.*`` / ``cost.*`` / ``comm.*`` gauges.
* :func:`pipeline_bubble_fraction`, :func:`bubble_from_spans` — copied
  (pure arithmetic).
* OOM forensics: :func:`is_oom_error` (also ``torch.cuda.OutOfMemoryError``),
  :class:`OOMForensics`, :func:`dump_oom_forensics` (stderr, and JSON at
  ``PADDLE_TPU_OOM_DUMP``), :func:`last_oom_report`.

Not ported: ``normalize_cost_analysis`` (there is no XLA cost analysis),
``collectives_from_jaxpr`` and ``collectives_from_hlo`` (no jaxpr and no
HLO); ``ROADMAP.md`` C names them.
"""
from __future__ import annotations

import json
import math
import os
import sys

from . import telemetry as _telemetry

__all__ = [
    "MemoryBreakdown",
    "CollectiveStats",
    "DeviceCostReport",
    "Harvest",
    "device_report",
    "enable_auto_harvest",
    "auto_harvest_enabled",
    "get_report",
    "last_report",
    "reports",
    "clear_reports",
    "pipeline_bubble_fraction",
    "bubble_from_spans",
    "is_oom_error",
    "OOMForensics",
    "dump_oom_forensics",
    "last_oom_report",
    "forensics_at_dispatch",
]

#: env var naming a directory for OOM forensics JSON dumps
OOM_DUMP_ENV = "PADDLE_TPU_OOM_DUMP"


# ---------------------------------------------------------------------------
# memory breakdown
# ---------------------------------------------------------------------------

class MemoryBreakdown:
    """Peak device-memory decomposition of one step.

    ``peak_bytes = argument + output + temp + generated_code − alias``
    (the JAX package's identity; see the module docstring for what each
    term measures in the port). ``alias_unavailable`` is kept for the JAX
    package's consumers and is always False here."""

    __slots__ = ("argument_bytes", "output_bytes", "temp_bytes",
                 "generated_code_bytes", "alias_bytes", "alias_unavailable")

    def __init__(self, argument_bytes=0, output_bytes=0, temp_bytes=0,
                 generated_code_bytes=0, alias_bytes=0,
                 alias_unavailable=False):
        self.argument_bytes = int(argument_bytes)
        self.output_bytes = int(output_bytes)
        self.temp_bytes = int(temp_bytes)
        self.generated_code_bytes = int(generated_code_bytes)
        self.alias_bytes = int(alias_bytes)
        self.alias_unavailable = bool(alias_unavailable)

    @property
    def peak_bytes(self):
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                + self.generated_code_bytes - self.alias_bytes)

    @classmethod
    def from_measured(cls, before, after, peak):
        """From the bytes held when a step starts and ends and the most
        held in between: ``alias`` is what both ends share, ``temp`` the
        peak above the larger end, so ``peak_bytes == peak``."""
        before, after = int(before), int(after)
        peak = max(int(peak), before, after)
        return cls(argument_bytes=before, output_bytes=after,
                   temp_bytes=peak - max(before, after),
                   alias_bytes=min(before, after))

    def as_dict(self):
        return {
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "alias_bytes": self.alias_bytes,
            "peak_bytes": self.peak_bytes,
            "alias_unavailable": self.alias_unavailable,
        }

    def __repr__(self):
        return (f"MemoryBreakdown(peak={self.peak_bytes}, "
                f"arg={self.argument_bytes}, out={self.output_bytes}, "
                f"temp={self.temp_bytes}, "
                f"code={self.generated_code_bytes}, "
                f"alias={self.alias_bytes})")


# ---------------------------------------------------------------------------
# collective accounting (copied; empty on one device)
# ---------------------------------------------------------------------------

class CollectiveStats:
    """Per-mesh-axis collective accounting: count, bytes moved (per
    participating device), and a per-primitive breakdown."""

    def __init__(self):
        self.by_axis = {}  # axis label -> {count, bytes, prims: {prim: n}}

    def add(self, axis, prim, nbytes, count=1):
        st = self.by_axis.setdefault(str(axis), {"count": 0, "bytes": 0.0,
                                                 "prims": {}})
        st["count"] += int(count)
        st["bytes"] += float(nbytes)
        st["prims"][prim] = st["prims"].get(prim, 0) + int(count)

    @property
    def total_bytes(self):
        return sum(st["bytes"] for st in self.by_axis.values())

    @property
    def total_count(self):
        return sum(st["count"] for st in self.by_axis.values())

    def axes(self):
        return sorted(self.by_axis)

    def as_dict(self):
        return {axis: {"count": st["count"], "bytes": st["bytes"],
                       "prims": dict(st["prims"])}
                for axis, st in self.by_axis.items()}

    def __bool__(self):
        return bool(self.by_axis)

    def __repr__(self):
        inner = ", ".join(f"{a}: {st['count']}x/{st['bytes']:.0f}B"
                          for a, st in sorted(self.by_axis.items()))
        return f"CollectiveStats({inner})"


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _fmt_bytes(n):
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0


class DeviceCostReport:
    """Measured cost/memory ground truth for one step.

    Attributes:
        name: step name.
        flops: aten operations (``FlopCounterMode``) plus the hand-written
            kernels' Pallas estimates.
        bytes_accessed: the aten operations' operand and result bytes plus
            the kernels' Pallas estimates.
        optimal_seconds: 0 (no cost model).
        memory: :class:`MemoryBreakdown` or None.
        collectives / collectives_traced: empty :class:`CollectiveStats`.
        comm_source: ``"none"``.
        kernels: ``{kernel: launches}`` counted by their estimate.
        uncounted_kernels: kernels launched without an estimate, by name.
        device: the device the step ran on.
    """

    def __init__(self, name, flops=0.0, bytes_accessed=0.0,
                 optimal_seconds=0.0, memory=None, collectives=None,
                 collectives_traced=None, comm_source="none", cost_raw=None,
                 kernels=None, uncounted_kernels=None, device="cpu"):
        self.name = name
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.optimal_seconds = float(optimal_seconds)
        self.memory = memory
        self.collectives = collectives or CollectiveStats()
        self.collectives_traced = collectives_traced or CollectiveStats()
        self.comm_source = comm_source
        self.cost_raw = dict(cost_raw or {})
        self.kernels = dict(kernels or {})
        self.uncounted_kernels = list(uncounted_kernels or [])
        self.device = str(device)

    @property
    def comm_bytes(self):
        """Interconnect bytes moved per device per step."""
        return self.collectives.total_bytes

    @property
    def comm_fraction(self):
        """``comm_bytes / (comm_bytes + bytes_accessed)``; 0.0 on one
        device."""
        denom = self.comm_bytes + self.bytes_accessed
        return self.comm_bytes / denom if denom > 0 else 0.0

    def as_dict(self):
        return {
            "name": self.name,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "optimal_seconds": self.optimal_seconds,
            "memory": self.memory.as_dict() if self.memory else None,
            "collectives": self.collectives.as_dict(),
            "collectives_traced": self.collectives_traced.as_dict(),
            "comm_source": self.comm_source,
            "comm_bytes": self.comm_bytes,
            "comm_fraction": self.comm_fraction,
            "kernels": dict(self.kernels),
            "uncounted_kernels": list(self.uncounted_kernels),
            "device": self.device,
        }

    def register(self, tm=None):
        """Publish into the telemetry registry: ``hbm.*`` / ``cost.*`` /
        ``comm.*`` gauges plus per-axis ``comm.{bytes,count}.<axis>``
        counters (counters accumulate across harvested steps)."""
        tm = tm or _telemetry.get_telemetry()
        if self.memory is not None:
            for k, v in self.memory.as_dict().items():
                tm.set_gauge(f"hbm.{k}", v)
        tm.set_gauge("cost.flops", self.flops)
        tm.set_gauge("cost.bytes_accessed", self.bytes_accessed)
        if self.optimal_seconds:
            tm.set_gauge("cost.optimal_seconds", self.optimal_seconds)
        tm.set_gauge("comm.bytes", self.comm_bytes)
        tm.set_gauge("comm.fraction", self.comm_fraction)
        for axis, st in self.collectives.by_axis.items():
            tm.inc(f"comm.bytes.{axis}", int(st["bytes"]))
            tm.inc(f"comm.count.{axis}", int(st["count"]))
        return self

    def table(self):
        """Human-readable summary (mirrors ``telemetry.report`` style)."""
        lines = [f"device cost report — {self.name} ({self.device})"]
        lines.append(f"  flops          {self.flops:,.0f}")
        lines.append(f"  bytes accessed {_fmt_bytes(self.bytes_accessed)}")
        if self.kernels:
            lines.append("  kernels counted by their Pallas estimate: "
                         + ", ".join(f"{k} x{n}" for k, n in
                                     sorted(self.kernels.items())))
        if self.uncounted_kernels:
            lines.append("  kernels without an estimate (not in flops): "
                         + ", ".join(self.uncounted_kernels))
        if self.memory is not None:
            md = self.memory.as_dict()
            peak = md.pop("peak_bytes") or 1
            alias = md.pop("alias_bytes")
            md.pop("alias_unavailable", None)
            lines.append(f"  hbm peak       {_fmt_bytes(peak)}")
            for k, v in sorted(md.items(), key=lambda kv: -kv[1]):
                if v:
                    lines.append(f"    {k:<22} {_fmt_bytes(v):>12} "
                                 f"({100.0 * v / peak:5.1f}%)")
            if alias:
                lines.append(f"    {'alias_bytes (reused)':<22} "
                             f"{'-' + _fmt_bytes(alias):>12}")
        if self.collectives:
            lines.append(f"  collectives ({self.comm_source}): "
                         f"{_fmt_bytes(self.comm_bytes)} moved/device, "
                         f"comm_fraction {self.comm_fraction:.4f}")
        else:
            lines.append("  collectives: none (single device)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# harvesting
# ---------------------------------------------------------------------------

_REPORTS = {}
_LAST_NAME = None
_AUTO = True


def enable_auto_harvest(flag=True):
    """Gate the once-per-step harvest hapi's train step runs on its first
    call while telemetry is enabled (on by default)."""
    global _AUTO
    _AUTO = bool(flag)


def auto_harvest_enabled():
    return _AUTO


def get_report(name):
    """Harvested :class:`DeviceCostReport` by step name, or None."""
    return _REPORTS.get(name)


def last_report():
    """The most recently harvested report (or None)."""
    return _REPORTS.get(_LAST_NAME) if _LAST_NAME else None


def reports():
    return dict(_REPORTS)


def clear_reports():
    global _LAST_NAME
    _REPORTS.clear()
    _LAST_NAME = None


def _tensors(obj, out):
    """Every tensor in a nest of lists, tuples and dicts, a ``Module``'s
    parameters and buffers included, into ``out``."""
    import torch

    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, torch.nn.Module):
        out.extend(obj.parameters())
        out.extend(obj.buffers())
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    return out


def _storage_bytes(tensors):
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        key = (t.device, st.data_ptr())
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def _device_of(obj):
    import torch

    for t in _tensors(obj, []):
        return t.device
    return torch.device("cpu")


def _byte_counter():
    """A dispatch mode summing each aten operation's operand and result
    bytes (views and ``empty`` move none)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    skip = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default}

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and func not in skip:
                self.bytes += sum(
                    t.numel() * t.element_size()
                    for t in tree_flatten((args, kwargs, out))[0]
                    if isinstance(t, torch.Tensor))
            return out

    return _Bytes()


class Harvest:
    """Measure one call of a step: ``with Harvest(name, inputs): step(...)``
    builds a :class:`DeviceCostReport` when the block ends without an
    error, stores it in the registry (``self.report``) and, when telemetry
    is on (or ``register=True``), publishes its gauges. ``inputs`` are the
    step's arguments (tensors, nests of them, ``Layer``s): they name the
    device, and on the CPU their bytes are the ``argument`` term."""

    def __init__(self, name, inputs=(), register=None):
        self.name = name
        self.inputs = inputs
        self.register = register
        self.report = None
        self.device = _device_of(inputs)

    def __enter__(self):
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        from ..ops.cuda.cost import KernelCost

        self._prof = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._before = torch.cuda.memory_stats(self.device)[
                "allocated_bytes.all.current"]
            torch.cuda.reset_peak_memory_stats(self.device)
        else:
            self._before = _storage_bytes(_tensors(self.inputs, []))
            if not torch.autograd.profiler._is_profiler_enabled:
                self._prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU],
                    profile_memory=True)
                self._prof.__enter__()
        self._kernels = KernelCost().__enter__()
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        self._bytes = _byte_counter()
        self._bytes.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        self._bytes.__exit__(exc_type, exc, tb)
        self._flops.__exit__(exc_type, exc, tb)
        self._kernels.__exit__(exc_type, exc, tb)
        if self.device.type == "cuda":
            if exc_type is None:
                torch.cuda.synchronize(self.device)
            stats = torch.cuda.memory_stats(self.device)
            after = stats["allocated_bytes.all.current"]
            peak = stats["allocated_bytes.all.peak"]
        else:
            after = peak = self._before
            if self._prof is not None:
                self._prof.__exit__(exc_type, exc, tb)
                run = top = 0
                for e in sorted(self._prof.events(),
                                key=lambda e: e.time_range.start):
                    run += e.self_cpu_memory_usage
                    top = max(top, run)
                after = max(0, self._before + run)
                peak = self._before + top
        if exc_type is not None:
            return False
        k = self._kernels
        self.report = _store(DeviceCostReport(
            name=self.name,
            flops=self._flops.get_total_flops() + k.flops,
            bytes_accessed=self._bytes.bytes + k.bytes_accessed,
            memory=MemoryBreakdown.from_measured(self._before, after, peak),
            cost_raw={"aten_flops": float(self._flops.get_total_flops()),
                      "aten_bytes": float(self._bytes.bytes),
                      "kernel_flops": k.flops,
                      "kernel_bytes": k.bytes_accessed,
                      "kernel_transcendentals": k.transcendentals},
            kernels=k.counted,
            uncounted_kernels=sorted(k.uncounted),
            device=self.device), self.register)
        return False


def _store(rep, register):
    global _LAST_NAME
    _REPORTS[rep.name] = rep
    _LAST_NAME = rep.name
    if register is None:
        register = _telemetry.enabled()
    if register:
        rep.register()
    return rep


def device_report(step, *args, name=None, register=None, **kwargs):
    """Run ``step(*args, **kwargs)`` ONCE under measurement and return its
    :class:`DeviceCostReport` (the JAX package lowers the step from shapes
    instead; the port has no compiled program to read, so the call's
    effects, a training step's update included, happen). The report goes
    to the registry under ``name`` (default: the step's ``name`` or
    ``__name__``) and, when telemetry is enabled or ``register=True``,
    into the ``hbm.*``/``cost.*``/``comm.*`` gauges."""
    import torch

    name = name or getattr(step, "name", None) or getattr(
        step, "__name__", "step")
    inputs = ((step, args, kwargs) if isinstance(step, torch.nn.Module)
              else (args, kwargs))
    with Harvest(name, inputs, register=register) as h:
        step(*args, **kwargs)
    return h.report


# ---------------------------------------------------------------------------
# pipeline / straggler metrics (copied: pure arithmetic)
# ---------------------------------------------------------------------------

def pipeline_bubble_fraction(num_microbatches, pp_degree):
    """Analytic 1F1B/GPipe schedule bubble: with M microbatches over pp
    stages the scan runs ``T = M + pp − 1`` ticks of which ``pp − 1`` are
    ramp-up/drain bubbles on every stage → ``(pp−1)/(M+pp−1)``."""
    m, pp = int(num_microbatches), int(pp_degree)
    if m <= 0 or pp <= 1:
        return 0.0
    return (pp - 1) / float(m + pp - 1)


def bubble_from_spans(spans):
    """Bubble fraction from measured (or synthetic) per-rank microbatch
    phase spans.

    Args:
        spans: ``{rank: [(start, end), ...]}`` or an iterable of
            ``(rank, start, end)`` tuples, on any consistent clock.

    Returns ``{"window_s", "per_rank": {rank: bubble}, "bubble_fraction"}``
    where each rank's bubble is the fraction of the global busy window
    it spent idle, and ``bubble_fraction`` is their mean."""
    if not isinstance(spans, dict):
        folded = {}
        for rank, t0, t1 in spans:
            folded.setdefault(rank, []).append((t0, t1))
        spans = folded
    all_spans = [s for ss in spans.values() for s in ss]
    if not all_spans:
        return {"window_s": 0.0, "per_rank": {}, "bubble_fraction": 0.0}
    t0 = min(s[0] for s in all_spans)
    t1 = max(s[1] for s in all_spans)
    window = max(t1 - t0, 0.0)
    per_rank = {}
    for rank, ss in spans.items():
        busy = sum(max(e - b, 0.0) for b, e in ss)
        per_rank[rank] = (max(1.0 - busy / window, 0.0) if window > 0
                          else 0.0)
    frac = (math.fsum(per_rank.values()) / len(per_rank)) if per_rank else 0.0
    return {"window_s": window, "per_rank": per_rank,
            "bubble_fraction": frac}


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

_LAST_OOM = None


def is_oom_error(err):
    """Does this exception look like a device OOM? A CUDA out-of-memory
    error, or an exception carrying XLA's ``RESOURCE_EXHAUSTED`` marker,
    which the injected ``oom`` fault raises."""
    import torch

    return (isinstance(err, torch.cuda.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(err))


def _rows(named, prefix):
    """``(path, tensor)`` pairs → ``(path, shape, dtype, nbytes)`` rows,
    largest first. Reads only tensor metadata."""
    rows = []
    for path, t in named:
        shape = tuple(int(s) for s in t.shape)
        rows.append({"path": f"{prefix}{path}", "shape": shape,
                     "dtype": str(t.dtype).replace("torch.", ""),
                     "nbytes": int(t.numel() * t.element_size())})
    rows.sort(key=lambda r: -r["nbytes"])
    return rows


def _named_args(obj, path=""):
    import torch

    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _named_args(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _named_args(v, f"{path}[{i}]")


class OOMForensics:
    """Structured post-mortem of a device OOM at dispatch: the harvested
    memory breakdown (when a harvest exists), donation status, and the
    batch/state tensors ranked by size."""

    def __init__(self, step_name, error, memory=None, donation=None,
                 batch=None, state=None, collectives=None):
        self.step_name = step_name
        self.error = str(error)
        self.memory = memory
        self.donation = dict(donation or {})
        self.batch = list(batch or [])
        self.state = list(state or [])
        self.collectives = dict(collectives or {})

    def as_dict(self):
        return {
            "step": self.step_name,
            "error": self.error,
            "memory": (self.memory.as_dict()
                       if isinstance(self.memory, MemoryBreakdown)
                       else self.memory),
            "donation": self.donation,
            "batch": self.batch,
            "state": self.state,
            "collectives": self.collectives,
        }

    @classmethod
    def from_dict(cls, d):
        mem = d.get("memory")
        if isinstance(mem, dict):
            mem = MemoryBreakdown(
                argument_bytes=mem.get("argument_bytes", 0),
                output_bytes=mem.get("output_bytes", 0),
                temp_bytes=mem.get("temp_bytes", 0),
                generated_code_bytes=mem.get("generated_code_bytes", 0),
                alias_bytes=mem.get("alias_bytes", 0),
                alias_unavailable=mem.get("alias_unavailable", False))
        return cls(d.get("step", "?"), d.get("error", ""), memory=mem,
                   donation=d.get("donation"), batch=d.get("batch"),
                   state=d.get("state"), collectives=d.get("collectives"))

    def report(self):
        lines = [f"OOM forensics — step '{self.step_name}' ran out of "
                 f"device memory at dispatch"]
        lines.append(f"  error: {self.error.splitlines()[0][:200]}"
                     if self.error else "  error: (no message)")
        if isinstance(self.memory, MemoryBreakdown):
            md = self.memory.as_dict()
            peak = md.pop("peak_bytes") or 1
            alias = md.pop("alias_bytes")
            md.pop("alias_unavailable", None)
            lines.append(f"  harvested memory breakdown "
                         f"(peak {_fmt_bytes(peak)}):")
            for k, v in sorted(md.items(), key=lambda kv: -kv[1]):
                if v:
                    lines.append(f"    {k:<22} {_fmt_bytes(v):>12} "
                                 f"({100.0 * v / peak:5.1f}%)")
            if alias:
                lines.append(f"    {'alias_bytes (reused)':<22} "
                             f"{'-' + _fmt_bytes(alias):>12}")
        else:
            lines.append("  harvested memory breakdown: unavailable "
                         "(step failed before/without a harvest)")
        don = self.donation
        lines.append(f"  donation: donate_state={don.get('donate_state')} "
                     f"donate_inputs={don.get('donate_inputs')} (the port "
                     "updates state in place; eager PyTorch donates nothing)")
        if self.batch:
            lines.append("  batch arrays (largest first):")
            for r in self.batch[:8]:
                lines.append(f"    {r['path']:<28} {str(r['shape']):<20} "
                             f"{r['dtype']:<10} {_fmt_bytes(r['nbytes'])}")
        if self.state:
            lines.append("  largest state arrays:")
            for r in self.state[:10]:
                lines.append(f"    {r['path']:<44} "
                             f"{_fmt_bytes(r['nbytes'])}")
        return "\n".join(lines)


def last_oom_report():
    """The most recent :class:`OOMForensics` (or None)."""
    return _LAST_OOM


def dump_oom_forensics(step, err, args, kwargs, file=None, state=()):
    """Build, print (stderr) and remember the forensics for an OOM raised
    at ``step``'s dispatch (``step``: its name, or an object with a
    ``name``); ``state`` is ``(path, tensor)`` pairs of the step's
    resident state. With ``PADDLE_TPU_OOM_DUMP=<dir>`` it also writes
    ``oom_<step>.json`` there. The caller re-raises the original error."""
    global _LAST_OOM

    name = step if isinstance(step, str) else getattr(step, "name", "?")
    rep = _REPORTS.get(name)
    fo = OOMForensics(
        step_name=name,
        error=err,
        memory=rep.memory if rep is not None else None,
        donation={"donate_state": False, "donate_inputs": False,
                  "donate_paths": []},
        batch=_rows(_named_args((args, kwargs or {}), "args"), "")[:16],
        state=_rows(state, "state.")[:16],
        collectives=rep.collectives.as_dict() if rep is not None else {},
    )
    _LAST_OOM = fo
    print(fo.report(), file=file or sys.stderr)
    if _telemetry.enabled():
        _telemetry.get_telemetry().inc("oom.count")
    dump_dir = os.environ.get(OOM_DUMP_ENV, "").strip()
    if dump_dir:
        try:
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(dump_dir, f"oom_{fo.step_name}.json")
            with open(path, "w") as f:
                json.dump(fo.as_dict(), f, indent=1)
        except OSError as e:  # forensics must not mask the OOM
            print(f"OOM forensics dump to {dump_dir} failed: {e!r}",
                  file=sys.stderr)
    return fo


def forensics_at_dispatch(name, fn, args, kwargs=None, state=None):
    """Run ``fn(*args, **kwargs)`` at the ``dispatch`` injection point:
    a device OOM (real or injected) dumps :func:`dump_oom_forensics`
    before it is re-raised; ``state`` is a callable giving the step's
    ``(path, tensor)`` state pairs, read only on an OOM."""
    from ..fault import inject

    kwargs = kwargs or {}
    try:
        inject.check("dispatch")
        return fn(*args, **kwargs)
    except Exception as e:
        if is_oom_error(e):
            try:
                dump_oom_forensics(name, e, args, kwargs,
                                   state=state() if state else ())
            except Exception as fe:  # noqa: BLE001 - never mask the OOM
                print(f"OOM forensics failed: {fe!r}", file=sys.stderr)
        raise
