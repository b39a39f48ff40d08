# Copied unchanged from paddle_tpu/fault/preempt.py: it needs no jax, and the port
# imports nothing of the JAX package.
"""Preemption (SIGTERM) handling for training loops.

TPU pods are preemptible: the scheduler sends SIGTERM and gives the job a
grace window. :class:`PreemptionGuard` converts that signal into a flag the
train loop polls at step boundaries — the loop then flushes a final
checkpoint (a *consistent* one, captured between optimizer steps) and
raises :class:`TrainingPreempted` instead of dying mid-step with nothing
on disk.

The previous SIGTERM disposition is chained and restored on uninstall, so
nesting guards (hapi fit inside a user harness that also traps SIGTERM)
composes.
"""
from __future__ import annotations

import signal
import threading
import warnings

__all__ = ["PreemptionGuard", "TrainingPreempted"]


class TrainingPreempted(RuntimeError):
    """Raised by a resumable fit loop after the preemption checkpoint is on
    disk. Carries the checkpoint ``step`` (global step id) when known."""

    def __init__(self, msg, step=None):
        super().__init__(msg)
        self.step = step


class PreemptionGuard:
    """Context manager that latches SIGTERM into ``self.preempted``.

    Signal handlers can only be installed from the main thread; elsewhere
    the guard degrades to an inert flag (a warning notes the preemption
    path is inactive) so library code never crashes a worker thread."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.preempted = False
        self._prev = {}
        self._installed = False

    def _handler(self, signum, frame):
        self.preempted = True
        from ..profiler import telemetry

        if telemetry.enabled():
            telemetry.get_telemetry().inc("fault.preemptions")

    def install(self):
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            warnings.warn(
                "PreemptionGuard installed off the main thread: SIGTERM "
                "cannot be trapped here, preemption checkpointing inactive")
            return self
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
