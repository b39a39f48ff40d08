"""Fault tolerance of the port — port of ``paddle_tpu/fault``: durable
checkpoints, kill-and-resume, retry with backoff, preemption handling, and
deterministic fault injection.

* :mod:`.checkpoint` — atomic, versioned, checksummed ``step_XXXXXXXX/``
  checkpoints with ``keep_last_n`` pruning and automatic fallback to the
  newest verified-good step (``CheckpointManager``), in the JAX package's
  format;
* :mod:`.state` — full train-state capture/restore (params, optimizer
  accumulators incl. fp32 master weights, LR scheduler, every torch
  generator the port draws from + host RNG, data cursor) and the
  ``ResumeSession`` runner behind ``hapi.Model.fit(resume=...)``;
* :mod:`.retry` / :mod:`.inject` / :mod:`.preempt` — jittered exponential
  backoff for transient I/O, deterministic fault injection (copies of the
  JAX package's jax-free modules) and the SIGTERM guard that flushes a
  final checkpoint before exit.
"""
from __future__ import annotations

from ..framework.io import CheckpointCorruptError  # noqa: F401
from . import inject  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .preempt import PreemptionGuard, TrainingPreempted  # noqa: F401
from .retry import TransientError, retriable, retry  # noqa: F401
from .state import ResumeSession, TrainState  # noqa: F401

__all__ = [
    "CheckpointCorruptError",
    "CheckpointManager",
    "PreemptionGuard",
    "TrainingPreempted",
    "TransientError",
    "ResumeSession",
    "TrainState",
    "retry",
    "retriable",
    "inject",
]
