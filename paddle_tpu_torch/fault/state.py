"""Full-state capture/restore for kill-and-resume training — port of
``paddle_tpu/fault/state.py``.

``TrainState`` snapshots everything a step's result depends on:

* model parameters + buffers (``Layer.state_dict``),
* optimizer accumulators — including fp32 master weights and the step
  counter — and the LR-scheduler state (both ride ``Optimizer.state_dict``),
* every generator the port draws from (where the JAX package keeps one jax
  PRNG key): the port's host generator (``framework.random``; it keys the
  flash kernels' Philox dropout through ``next_seed_words``), its CUDA
  generator (the dense path's ``torch.bernoulli`` mask on the card),
  PyTorch's global CPU and CUDA generators (``nn.Dropout``,
  ``torch.bernoulli`` without a generator) and the last ``seed``,
* the host RNG (numpy + python ``random``) as of the *epoch start* — the
  shuffle permutation of the interrupted epoch is drawn from it, so a
  mid-epoch resume re-creates the epoch iterator from the same state and
  replays the identical batch order before skipping the consumed prefix,
* the data cursor (epoch, steps completed in it, global step).

A directory the JAX package wrote restores here too: its parameters, its
optimizer's accumulators (keyed by the JAX parameters' names, taken in the
optimizer's parameter order), the scheduler, the cursor and the host RNG.
Its jax key cannot seed a torch generator and is skipped with a warning.

``ResumeSession`` is the loop-side runner used by ``hapi.Model.fit``:
restore-on-entry, per-step preemption check + periodic saves, epoch-end
saves, SIGTERM flush. Restored correctly, a run killed mid-epoch and
resumed reproduces the uninterrupted run's loss trajectory bitwise
(``tests/test_torch_fault.py``).
"""
from __future__ import annotations

import random as _pyrandom
import warnings

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .preempt import PreemptionGuard, TrainingPreempted

__all__ = ["TrainState", "ResumeSession", "TrainingPreempted"]


# -- torch generators (where the JAX package (de)serializes its key) ---------

def _torch_rng_state():
    from ..framework import random as prandom

    rec = {"seed": prandom._seed,
           "port_cpu": prandom.get_rng_state(),
           "torch_cpu": torch.get_rng_state()}
    if torch.cuda.is_available():
        rec["port_cuda"] = prandom.get_cuda_rng_state()
        rec["torch_cuda"] = list(torch.cuda.get_rng_state_all())
    return rec


def _bytes(state):
    """A generator state (a uint8 tensor, or the numpy array a checkpoint
    holds) as a CPU ``torch.uint8`` tensor."""
    if isinstance(state, torch.Tensor):
        return state.detach().as_subclass(torch.Tensor).cpu().to(torch.uint8)
    return torch.from_numpy(np.array(state, np.uint8))


def _torch_rng_restore(rec):
    from ..framework import random as prandom

    prandom._seed = int(rec["seed"])
    prandom.set_rng_state(_bytes(rec["port_cpu"]))
    torch.set_rng_state(_bytes(rec["torch_cpu"]))
    if torch.cuda.is_available():
        if "port_cuda" in rec:
            prandom.set_cuda_rng_state(_bytes(rec["port_cuda"]))
        if "torch_cuda" in rec:
            torch.cuda.set_rng_state_all([_bytes(s)
                                          for s in rec["torch_cuda"]])


def _jax_optimizer_state(state, optimizer):
    """A JAX optimizer ``state_dict`` (accumulators keyed
    ``f"{param.name}_{accumulator}"``) in the port's keys (``param_<i>``):
    the JAX optimizer makes its accumulators in its parameter order, so the
    i-th parameter name met is the port optimizer's i-th parameter."""
    from ..models.convert import _ACCUMULATORS

    order, out = [], {}
    for k, v in state.items():
        if k in ("@step", "LR_Scheduler"):
            out[k] = v
            continue
        acc = next((a for a in _ACCUMULATORS if k.endswith("_" + a)), None)
        if acc is None:
            raise KeyError(f"optimizer state entry {k!r} names no accumulator")
        name = k[:-len(acc) - 1]
        if name not in order:
            order.append(name)
        out[(order.index(name), acc)] = v
    params = optimizer._parameter_list
    if len(order) > len(params):
        raise ValueError(f"the checkpoint's optimizer holds {len(order)} "
                         f"parameters, the optimizer {len(params)}")
    return {(f"{optimizer._pkey(params[k[0]])}_{k[1]}"
             if isinstance(k, tuple) else k): v for k, v in out.items()}


class TrainState:
    """Capture/restore of one (network, optimizer) training pair."""

    @staticmethod
    def capture(network, optimizer=None):
        """Payload dict for :meth:`CheckpointManager.save`."""
        payloads = {"model": network.state_dict(),
                    "rng": {"torch": _torch_rng_state()}}
        if optimizer is not None:
            payloads["optimizer"] = optimizer.state_dict()
        return payloads

    @staticmethod
    def restore(payloads, network, optimizer=None):
        network.set_state_dict(payloads["model"])
        rng = payloads.get("rng") or {}
        jax_written = "jax" in rng and "torch" not in rng
        if optimizer is not None and "optimizer" in payloads:
            state = payloads["optimizer"]
            if jax_written:
                state = _jax_optimizer_state(state, optimizer)
            optimizer.set_state_dict(state)
        if "torch" in rng:
            _torch_rng_restore(rng["torch"])
        elif "jax" in rng:
            warnings.warn(
                "checkpoint written by the JAX package: its jax PRNG key "
                "cannot seed a torch generator and is skipped (the host "
                "RNG, the cursor and all tensors are restored)")


def _host_rng_snapshot():
    return {"np": np.random.get_state(), "py": _pyrandom.getstate()}


def _host_rng_restore(snap):
    if not snap:
        return
    if snap.get("np") is not None:
        np.random.set_state(tuple(snap["np"]))
    if snap.get("py") is not None:
        # pickle round-trips the tuple as nested lists; random wants tuples
        st = snap["py"]
        _pyrandom.setstate(tuple(
            tuple(x) if isinstance(x, list) else x for x in st))


class ResumeSession:
    """Drives checkpoint/resume for one fit run.

    Protocol (the fit loop calls, in order)::

        sess = ResumeSession(resume, network, optimizer, ...)
        start_epoch, start_step = sess.restore()
        for epoch in range(start_epoch, epochs):
            sess.epoch_begin(epoch)
            skip = start_step if epoch == start_epoch else 0
            for step in steps(skipping first `skip`):
                ... run one optimizer step ...
                sess.after_step(epoch, step + 1)   # may raise TrainingPreempted
            sess.epoch_end(epoch)
        sess.close()            # in a finally:

    ``after_step`` polls the SIGTERM guard (and the ``train.step``
    injection point); on preemption it flushes a consistent checkpoint at
    the just-completed step boundary and raises :class:`TrainingPreempted`.
    A save reads the model and optimizer back to the host: it is a fence.
    """

    def __init__(self, resume, network, optimizer=None, keep_last_n=None,
                 ckpt_freq=None, save_every_epochs=1):
        self.manager = (resume if isinstance(resume, CheckpointManager)
                        else CheckpointManager(resume, keep_last_n=keep_last_n))
        if keep_last_n and not self.manager.keep_last_n:
            self.manager.keep_last_n = int(keep_last_n)
        self.network = network
        self.optimizer = optimizer
        self.ckpt_freq = int(ckpt_freq) if ckpt_freq else 0
        self.save_every_epochs = max(0, int(save_every_epochs or 0))
        self.guard = PreemptionGuard().install()
        self.global_step = 0
        self.start_epoch = 0
        self.start_step = 0
        self._epoch_host_rng = None

    # -- restore -------------------------------------------------------------
    def restore(self):
        """Load the newest verified checkpoint (if any) into the network /
        optimizer / RNGs and return ``(start_epoch, start_step)`` — the
        cursor the loop resumes from. Fresh directory: ``(0, 0)``."""
        try:
            loaded = self.manager.load()
        except BaseException:
            self.close()  # don't leak the SIGTERM handler on a failed start
            raise
        if loaded is None:
            return 0, 0
        _, payloads = loaded
        TrainState.restore(payloads, self.network, self.optimizer)
        cur = payloads.get("cursor") or {}
        self.start_epoch = int(cur.get("epoch", 0))
        self.start_step = int(cur.get("step", 0))
        self.global_step = int(cur.get("global_step", 0))
        # rewind the host RNG to the cursor epoch's start so the resumed
        # epoch's shuffle permutation replays identically
        _host_rng_restore((payloads.get("rng") or {}).get("host_epoch_start"))
        return self.start_epoch, self.start_step

    # -- loop hooks ----------------------------------------------------------
    def epoch_begin(self, epoch):
        # snapshot BEFORE the loader iterator draws the epoch permutation
        self._epoch_host_rng = _host_rng_snapshot()

    def save(self, epoch, steps_done, at_epoch_end=False):
        if at_epoch_end:
            cursor = {"epoch": epoch + 1, "step": 0,
                      "global_step": self.global_step}
            host = _host_rng_snapshot()  # state entering the next epoch
        else:
            cursor = {"epoch": epoch, "step": steps_done,
                      "global_step": self.global_step}
            host = self._epoch_host_rng or _host_rng_snapshot()
        payloads = TrainState.capture(self.network, self.optimizer)
        payloads["cursor"] = cursor
        payloads["rng"]["host_epoch_start"] = host
        return self.manager.save(self.global_step, payloads)

    def after_step(self, epoch, steps_done):
        """Call once per completed optimizer step with the count of steps
        done in this epoch. Periodic save per ``ckpt_freq``; on SIGTERM,
        flush and raise :class:`TrainingPreempted`."""
        from . import inject

        self.global_step += 1
        inject.check("train.step")
        preempted = self.guard.preempted
        if preempted or (self.ckpt_freq
                         and steps_done % self.ckpt_freq == 0):
            self.save(epoch, steps_done)
        if preempted:
            raise TrainingPreempted(
                f"SIGTERM at epoch {epoch} step {steps_done}: checkpoint "
                f"flushed to {self.manager.root!r}", step=self.global_step)

    def epoch_end(self, epoch):
        if self.save_every_epochs and (epoch + 1) % self.save_every_epochs == 0:
            self.save(epoch, 0, at_epoch_end=True)

    def close(self):
        self.guard.uninstall()
