# Copied unchanged from paddle_tpu/profiler/slo.py: it needs no jax, and the port
# imports nothing of the JAX package. It reads the port's telemetry registry
# (profiler/telemetry.py).
"""Declarative SLOs with multi-window burn-rate alerting.

Aggregate telemetry still needs a human watching it; this module turns the
registry into pages. An SLO is a one-line spec string evaluated against the
live :class:`~paddle_tpu.profiler.telemetry.Telemetry` registry::

    serve.latency_s p95 < 0.5        # histogram percentile (reservoir)
    serve.ttft_s    p95 < 1.0
    serve.queue_depth    < 16        # gauge (or counter) by bare name
    fault.giveups       == 0         # absent counters read as 0
    serve.decode_steps rate > 1.0 @ 0.999   # counter rate/s, objective 0.999

Grammar: ``<metric> [<stat>] <op> <threshold> [@ <objective>]`` where
``stat`` is ``p<NN>`` / ``mean`` / ``count`` / ``sum`` / ``min`` / ``max``
/ ``rate`` (counter delta per second between checks) and ``op`` is one of
``< <= > >= == !=``.

:class:`SLOMonitor` samples every spec on each :meth:`~SLOMonitor.check`
(the Scheduler ticks it every ``slo_check_every`` steps; the
``TelemetryLogger`` callback every ``log_freq`` batches) and keeps a
timestamped compliance window per spec. Alerting follows the SRE
multi-window burn-rate recipe: with error budget ``1 - objective``, the
burn rate over a window is ``bad_fraction / budget``, and an alert fires
only when EVERY configured window exceeds its threshold — the short window
gives fast detection, the long one keeps one-sample blips from paging.
Alerts dedupe until the spec recovers (all windows back under threshold).

Sinks are pluggable callables; :func:`log_alert_sink` (RuntimeWarning) and
:class:`JsonlAlertSink` ship in the box. The clock is injectable so burn
windows are testable without sleeping.
"""
from __future__ import annotations

import json
import re
import time
import warnings
from collections import deque

__all__ = [
    "SLOSpec",
    "SLOMonitor",
    "log_alert_sink",
    "JsonlAlertSink",
    "DEFAULT_WINDOWS",
    "SERVING_SLOS",
]

#: Shipped serving-overload objectives (``Scheduler(slo=
#: serving.default_slo_monitor())`` wires them in). Counter rates and
#: histogram percentiles ONLY — never the ``serve.requests_in_flight`` /
#: ``serve.queue_depth`` gauges, which are RETIRED (absent, not 0) once a
#: scheduler drains; a gauge-based spec would fall through to the
#: counters-read-as-0 path and silently stop measuring. The rate specs
#: page when sheds/timeouts/OOM evictions burn faster than ~1/s across
#: the burn windows — i.e. sustained overload, not a single rejected
#: request.
SERVING_SLOS = (
    "serve.shed rate < 1 @ 0.999",
    "serve.timeouts rate < 1 @ 0.999",
    "serve.oom_evictions rate < 1 @ 0.999",
    "serve.errors rate < 1 @ 0.999",
    "serve.latency_s p95 < 2.0 @ 0.99",
    "serve.ttft_s p95 < 1.0 @ 0.99",
)

#: (window_seconds, burn-rate threshold): fast page at 14.4x (2% of a
#: 30-day budget in an hour, scaled down to serving-loop timescales) plus a
#: slower confirmation window. All windows must burn for an alert.
DEFAULT_WINDOWS = ((60.0, 14.4), (600.0, 6.0))

_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

_STAT_RE = re.compile(r"^(p\d{1,2}(\.\d+)?|mean|count|sum|min|max|rate)$")
_SPEC_RE = re.compile(
    r"^\s*(?P<metric>[A-Za-z0-9_.\-/]+)"
    r"(\s+(?P<stat>p\d{1,2}(\.\d+)?|mean|count|sum|min|max|rate))?"
    r"\s*(?P<op><=|>=|==|!=|<|>)"
    r"\s*(?P<thr>[-+0-9.eE]+)"
    r"(\s*@\s*(?P<obj>0?\.\d+|1(\.0*)?))?\s*$")


class SLOSpec:
    """One parsed objective: ``value(telemetry)`` resolves the live value,
    ``evaluate`` applies the comparison."""

    def __init__(self, metric, op, threshold, stat=None, objective=None,
                 name=None):
        if op not in _OPS:
            raise ValueError(f"unknown comparison {op!r}")
        if stat is not None and not _STAT_RE.match(stat):
            raise ValueError(f"unknown stat {stat!r}")
        self.metric = metric
        self.stat = stat
        self.op = op
        self.threshold = float(threshold)
        self.objective = float(objective) if objective is not None else None
        if self.objective is not None and not (0.0 < self.objective <= 1.0):
            raise ValueError(f"objective {objective} outside (0, 1]")
        self.name = name or self._default_name()

    def _default_name(self):
        stat = f" {self.stat}" if self.stat else ""
        return f"{self.metric}{stat} {self.op} {self.threshold:g}"

    @classmethod
    def parse(cls, text):
        """Parse a spec string (see module grammar). Raises ``ValueError``
        with the offending text on mismatch."""
        m = _SPEC_RE.match(text)
        if m is None:
            raise ValueError(
                f"unparseable SLO spec {text!r} (want '<metric> [stat] "
                f"<op> <threshold> [@ <objective>]')")
        return cls(m.group("metric"), m.group("op"), float(m.group("thr")),
                   stat=m.group("stat"), objective=m.group("obj"),
                   name=text.strip())

    def value(self, telemetry, rate_state=None, now=None):
        """Resolve the spec's current value against the registry. Returns
        None when there is no data yet (histogram stat with no samples, or
        a ``rate`` on its first reading)."""
        if self.stat == "rate":
            cur = telemetry.counters().get(self.metric)
            if cur is None:
                cur = 0.0
            now = time.monotonic() if now is None else now
            prev = None if rate_state is None \
                else rate_state.get(self.metric)
            if rate_state is not None:
                rate_state[self.metric] = (now, float(cur))
            if prev is None or now <= prev[0]:
                return None
            return (float(cur) - prev[1]) / (now - prev[0])
        if self.stat is not None:
            st = telemetry.stat(self.metric, self.stat)
            return st  # None when the histogram has no samples
        gauges = telemetry.gauges()
        if self.metric in gauges:
            return gauges[self.metric]
        # counters (absent == never incremented == 0: `fault.giveups == 0`
        # must hold on a clean process)
        return float(telemetry.counters().get(self.metric, 0.0))

    def evaluate(self, telemetry, rate_state=None, now=None):
        """→ ``(ok, value)``; ``(None, None)`` when there is no data."""
        v = self.value(telemetry, rate_state=rate_state, now=now)
        if v is None:
            return None, None
        return bool(_OPS[self.op](float(v), self.threshold)), float(v)

    def __repr__(self):
        return f"<SLOSpec {self.name!r}>"


def log_alert_sink(alert):
    """Default sink: a ``RuntimeWarning`` naming the spec, value and burn
    rates (shows up in logs/pytest without any wiring)."""
    wins = ", ".join(f"{int(w['window_s'])}s burn {w['burn_rate']:.1f}x"
                     f" (max {w['max_burn']:g})"
                     for w in alert["windows"])
    warnings.warn(
        f"SLO burn: {alert['spec']} — value {alert['value']:g} "
        f"violates the objective; {wins}", RuntimeWarning, stacklevel=3)


class JsonlAlertSink:
    """Append alerts as JSON lines (one object per alert) to ``path``."""

    def __init__(self, path):
        self.path = str(path)

    def __call__(self, alert):
        with open(self.path, "a") as f:
            f.write(json.dumps(alert) + "\n")


class _SpecState:
    __slots__ = ("samples", "firing", "last_value", "last_ok", "alerts")

    def __init__(self, history):
        self.samples = deque(maxlen=history)  # (t, ok) compliance series
        self.firing = False
        self.last_value = None
        self.last_ok = None
        self.alerts = 0


class SLOMonitor:
    """Evaluate SLO specs against the telemetry registry and page through
    sinks on multi-window burn.

    Args:
        specs: iterable of :class:`SLOSpec` or spec strings.
        objective: default availability objective (fraction of checks that
            must pass) for specs that don't carry their own ``@``.
        windows: ``((seconds, max_burn), ...)`` — ALL windows must exceed
            their burn threshold to alert.
        sinks: callables invoked with the alert dict; defaults to
            :func:`log_alert_sink`.
        telemetry: registry to read; defaults to the process-wide one.
        clock: injectable time source (seconds; ``time.monotonic``).
        history: bounded per-spec compliance samples.
    """

    def __init__(self, specs, objective=0.99, windows=DEFAULT_WINDOWS,
                 sinks=None, telemetry=None, clock=time.monotonic,
                 history=4096):
        self.specs = [s if isinstance(s, SLOSpec) else SLOSpec.parse(s)
                      for s in specs]
        if not (0.0 < float(objective) < 1.0):
            raise ValueError("objective must be in (0, 1)")
        self.objective = float(objective)
        self.windows = tuple((float(w), float(b)) for w, b in windows)
        if not self.windows:
            raise ValueError("at least one burn window required")
        self.sinks = list(sinks) if sinks is not None else [log_alert_sink]
        self._telemetry = telemetry
        self.clock = clock
        self._state = {s.name: _SpecState(history) for s in self.specs}
        self._rate_state = {}
        self.alerts = []
        self.checks = 0

    def _tm(self):
        if self._telemetry is not None:
            return self._telemetry
        from . import telemetry as _telemetry

        return _telemetry.get_telemetry()

    def _budget(self, spec):
        obj = spec.objective if spec.objective is not None else self.objective
        return max(1.0 - obj, 1e-9)

    def burn_rates(self, spec, now=None):
        """Per-window burn for one spec: ``[{window_s, burn_rate,
        max_burn, samples}]`` over whatever samples each window holds."""
        now = self.clock() if now is None else now
        st = self._state[spec.name]
        budget = self._budget(spec)
        out = []
        for win, max_burn in self.windows:
            in_win = [ok for (t, ok) in st.samples if now - t <= win]
            bad = sum(1 for ok in in_win if not ok)
            frac = bad / len(in_win) if in_win else 0.0
            out.append({"window_s": win, "max_burn": max_burn,
                        "samples": len(in_win),
                        "bad_fraction": frac,
                        "burn_rate": frac / budget})
        return out

    def check(self, now=None):
        """Sample every spec once; fire/refresh alerts. Returns the alerts
        fired by THIS check (possibly empty)."""
        now = self.clock() if now is None else now
        self.checks += 1
        fired = []
        for spec in self.specs:
            ok, value = spec.evaluate(self._tm(),
                                      rate_state=self._rate_state, now=now)
            st = self._state[spec.name]
            if ok is None:
                continue  # no data: no compliance sample either way
            st.samples.append((now, ok))
            st.last_value = value
            st.last_ok = ok
            burns = self.burn_rates(spec, now=now)
            burning = all(b["samples"] > 0
                          and b["burn_rate"] >= b["max_burn"]
                          for b in burns)
            if burning and not st.firing:
                st.firing = True
                st.alerts += 1
                alert = {
                    "ts": now,
                    "spec": spec.name,
                    "metric": spec.metric,
                    "value": value,
                    "threshold": spec.threshold,
                    "objective": spec.objective or self.objective,
                    "windows": burns,
                }
                self.alerts.append(alert)
                fired.append(alert)
                for sink in self.sinks:
                    try:
                        sink(alert)
                    except Exception as e:  # noqa: BLE001
                        warnings.warn(f"SLO alert sink {sink!r} failed: {e}",
                                      RuntimeWarning, stacklevel=2)
            elif not burning and st.firing:
                st.firing = False  # recovered: re-arm
        return fired

    def status(self):
        """Per-spec snapshot: last value/ok, compliance, burn, alert and
        firing state — the machine-readable side of :meth:`report`."""
        out = []
        for spec in self.specs:
            st = self._state[spec.name]
            n = len(st.samples)
            good = sum(1 for _, ok in st.samples if ok)
            out.append({
                "spec": spec.name,
                "value": st.last_value,
                "ok": st.last_ok,
                "samples": n,
                "compliance": good / n if n else None,
                "burn": self.burn_rates(spec),
                "firing": st.firing,
                "alerts": st.alerts,
            })
        return out

    def report(self, file=None):
        """Printable SLO table (printed and returned, mirroring
        ``telemetry.report``)."""
        lines = [f"{'SLO':<44} {'value':>12} {'compliance':>11} "
                 f"{'burn':>8} {'alerts':>7} {'state':>7}"]
        lines.append("-" * 94)
        for s in self.status():
            value = "-" if s["value"] is None else f"{s['value']:g}"
            comp = ("-" if s["compliance"] is None
                    else f"{100.0 * s['compliance']:.1f}%")
            burn = max((b["burn_rate"] for b in s["burn"]), default=0.0)
            state = "FIRING" if s["firing"] else "ok"
            lines.append(f"{s['spec']:<44} {value:>12} {comp:>11} "
                         f"{burn:>8.1f} {s['alerts']:>7} {state:>7}")
        lines.append(f"checks: {self.checks}  objective: {self.objective}  "
                     f"windows: " + ", ".join(
                         f"{int(w)}s@{b:g}x" for w, b in self.windows))
        table = "\n".join(lines)
        print(table, file=file)
        return table
