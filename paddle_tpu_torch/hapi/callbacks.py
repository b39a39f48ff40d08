# Copied from paddle_tpu/hapi/callbacks.py (the port imports nothing of the
# JAX package); VisualDL and TelemetryLogger run on the port's copies of
# utils/log_writer.py, profiler/telemetry.py and profiler/slo.py, and
# DeviceStatsLogger raises until profiler/devprof is ported (ROADMAP.md A6).
"""hapi callbacks (reference ``python/paddle/hapi/callbacks.py``):
Callback base + CallbackList dispatch, ProgBarLogger, ModelCheckpoint,
LRScheduler, EarlyStopping, Terminate-on-NaN-style guards live in user land.
"""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = [
    "Callback",
    "ProgBarLogger",
    "ModelCheckpoint",
    "LRScheduler",
    "EarlyStopping",
    "VisualDL",
    "TelemetryLogger",
    "DeviceStatsLogger",
]


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    """Reference ``callbacks.py:31`` — assemble the default callback list."""
    cbks = callbacks or []
    cbks = cbks if isinstance(cbks, (list, tuple)) else [cbks]
    if not any(isinstance(k, ProgBarLogger) for k in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + list(cbks)
    if not any(isinstance(k, LRScheduler) for k in cbks):
        cbks = [LRScheduler()] + list(cbks)
    if not any(isinstance(k, ModelCheckpoint) for k in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    metrics = metrics or []
    params = {
        "batch_size": batch_size,
        "epochs": epochs,
        "steps": steps,
        "verbose": verbose,
        "metrics": metrics,
    }
    cbk_list.set_params(params)
    return cbk_list


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = [c for c in (callbacks or [])]
        self.params = {}
        self.model = None

    def append(self, callback):
        self.callbacks.append(callback)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        self.params = params
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        self.model = model
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call(f"on_{mode}_begin", logs)

    def on_end(self, mode, logs=None):
        self._call(f"on_{mode}_end", logs)

    def on_epoch_begin(self, epoch=None, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch=None, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step=None, logs=None):
        self._call(f"on_{mode}_batch_begin", step, logs)

    def on_batch_end(self, mode, step=None, logs=None):
        self._call(f"on_{mode}_batch_end", step, logs)


class Callback:
    """Reference ``callbacks.py:128``."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class ProgBarLogger(Callback):
    """Reference ``callbacks.py:298`` — per-epoch progress + metric lines."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self.epochs = None
        self.steps = None

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch=None, logs=None):
        self.steps = self.params.get("steps")
        self.epoch = epoch
        self.train_step = 0
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, (numbers.Number, np.floating)):
                parts.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], numbers.Number):
                parts.append(f"{k}: " + ", ".join(f"{x:.4f}" for x in v))
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        self.train_step += 1
        if self.verbose > 1 and self.train_step % self.log_freq == 0:
            print(f"step {self.train_step}/{self.steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1}: {self._fmt(logs)}")

    def on_eval_begin(self, logs=None):
        self.eval_step = 0
        if self.verbose:
            print("Eval begin...")

    def on_eval_batch_end(self, step, logs=None):
        self.eval_step += 1

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval samples: {(logs or {}).get('eval_samples', '?')} - "
                  f"{self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """Reference ``callbacks.py:534`` — save every ``save_freq`` epochs +
    final.

    When the last epoch was already saved by ``save_freq``, ``final`` is
    not re-serialized (a second full write of the same state): it is
    hardlinked (copy fallback) to that epoch's files. ``keep_last_n``
    prunes older per-epoch checkpoints, delegated to
    ``fault.CheckpointManager.prune_flat``; ``final`` survives pruning."""

    def __init__(self, save_freq=1, save_dir=None, keep_last_n=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.keep_last_n = keep_last_n
        self._saved_epochs = []
        self._last_epoch = None

    def on_epoch_end(self, epoch, logs=None):
        self._last_epoch = epoch
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            print(f"save checkpoint at {os.path.abspath(path)}")
            self.model.save(path)
            self._saved_epochs.append(epoch)
            if self.keep_last_n:
                from ..fault import CheckpointManager

                pruned = CheckpointManager.prune_flat(
                    self.save_dir, self._saved_epochs, self.keep_last_n)
                self._saved_epochs = [e for e in self._saved_epochs
                                      if e not in pruned]

    def _alias_final(self, epoch):
        """Point ``final.*`` at epoch ``epoch``'s files without rewriting
        the checkpoint (hardlink; copy when linking is unsupported)."""
        import shutil

        for ext in (".pdparams", ".pdopt"):
            src = os.path.join(self.save_dir, str(epoch) + ext)
            dst = os.path.join(self.save_dir, "final" + ext)
            if not os.path.exists(src):
                continue
            try:
                os.remove(dst)
            except OSError:
                pass
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)

    def on_train_end(self, logs=None):
        if not self.save_dir:
            return
        path = os.path.join(self.save_dir, "final")
        if self._last_epoch is not None and self._saved_epochs \
                and self._saved_epochs[-1] == self._last_epoch:
            # the last epoch's checkpoint IS the final state: alias it
            # instead of serializing the whole model a second time
            print(f"alias final checkpoint -> epoch {self._last_epoch} "
                  f"at {os.path.abspath(path)}")
            self._alias_final(self._last_epoch)
            return
        print(f"save checkpoint at {os.path.abspath(path)}")
        self.model.save(path)


class LRScheduler(Callback):
    """Reference ``callbacks.py:599`` — step the optimizer's LRScheduler."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class VisualDL(Callback):
    """Reference ``callbacks.py VisualDL``: stream train/eval scalars to a
    LogWriter (JSONL records, utils/log_writer.py)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._train_step = 0

    def _w(self):
        if self._writer is None:
            from ..utils.log_writer import LogWriter

            self._writer = LogWriter(self.log_dir)
        return self._writer

    def _log(self, prefix, logs, step):
        import numbers

        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                self._w().add_scalar(f"{prefix}/{k}", v, step)
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], numbers.Number):
                self._w().add_scalar(f"{prefix}/{k}", v[0], step)

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        self._log("train", logs, self._train_step)

    def on_eval_end(self, logs=None):
        self._log("eval", logs, self._train_step)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class TelemetryLogger(Callback):
    """Turn on the runtime telemetry layer (``profiler.telemetry``) for the
    run and surface it: pipeline phase scalars (data_wait / h2d_copy /
    compile / dispatch / readback), DeviceLoader queue stats and the
    recompile counter stream to a ``LogWriter`` JSONL every ``log_freq``
    train batches (render with ``tools/telemetry_report.py``), and the
    phase-breakdown table prints at train end.

    SLO monitoring rides along: pass ``slo=`` a list of spec strings (see
    ``profiler.slo`` — e.g. ``"step.time_s < 0.5"``,
    ``"phase.data_wait p95 < 0.1"``) or a prebuilt
    :class:`~paddle_tpu.profiler.slo.SLOMonitor`, and the callback samples
    it every ``log_freq`` batches; burn-rate alerts fire through the
    monitor's sinks mid-run and the SLO table prints at train end.

    Args:
        log_dir: JSONL output directory; ``None`` keeps the registry
            in-memory only (``telemetry.report()`` still works).
        log_freq: export cadence, in train batches.
        print_report: print ``telemetry.report()`` on train end.
        reset_on_begin: clear the registry at train begin so the report
            covers exactly this run.
        slo: SLO spec strings (or an ``SLOMonitor``) sampled at the export
            cadence; the monitor stays on ``self.slo_monitor``.
    """

    def __init__(self, log_dir=None, log_freq=10, print_report=True,
                 reset_on_begin=True, slo=None):
        super().__init__()
        self.log_dir = log_dir
        self.log_freq = max(1, int(log_freq or 1))
        self.print_report = print_report
        self.reset_on_begin = reset_on_begin
        self._slo_arg = slo
        self.slo_monitor = None
        self._writer = None
        self._train_step = 0
        self._enabled_here = False

    def _tm(self):
        from ..profiler import telemetry

        return telemetry

    def _w(self):
        if self._writer is None and self.log_dir:
            from ..utils.log_writer import LogWriter

            self._writer = LogWriter(self.log_dir)
        return self._writer

    def on_train_begin(self, logs=None):
        telemetry = self._tm()
        self._train_step = 0
        if self.reset_on_begin:
            telemetry.reset()
        if not telemetry.enabled():
            telemetry.enable()
            self._enabled_here = True
        if self._slo_arg is not None and self.slo_monitor is None:
            from ..profiler.slo import SLOMonitor

            self.slo_monitor = (
                self._slo_arg if isinstance(self._slo_arg, SLOMonitor)
                else SLOMonitor(self._slo_arg))

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        if self._train_step % self.log_freq == 0:
            if self.log_dir:
                self._tm().get_telemetry().export_scalars(
                    self._w(), step=self._train_step)
            if self.slo_monitor is not None:
                self.slo_monitor.check()

    def on_train_end(self, logs=None):
        telemetry = self._tm()
        if self.log_dir:
            telemetry.get_telemetry().export_scalars(
                self._w(), step=self._train_step)
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self.slo_monitor is not None:
            self.slo_monitor.check()
        if self.print_report:
            telemetry.report()
            if self.slo_monitor is not None:
                self.slo_monitor.report()
        if self._enabled_here:
            telemetry.disable()
            self._enabled_here = False


class DeviceStatsLogger(Callback):
    """The JAX package's callback prints the compiled train step's device
    cost report (``profiler/devprof``: FLOPs, bytes, the memory peak broken
    down, collective bytes). The port has no ``devprof`` yet
    (``ROADMAP.md`` A6): constructing it raises."""

    def __init__(self, log_dir=None, print_report=True):
        raise NotImplementedError(
            "DeviceStatsLogger reads profiler/devprof, which the port does "
            "not have yet (ROADMAP.md A6)")


class EarlyStopping(Callback):
    """Reference ``callbacks.py`` EarlyStopping: stop when a monitored metric
    stops improving."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        self.save_dir = None
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        self.best_value = (self.baseline if self.baseline is not None
                           else (np.inf if self.monitor_op == np.less else -np.inf))
        self.model.stop_training = False

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience:
            self.model.stop_training = True
            if self.verbose:
                print(f"Early stopping: monitored {self.monitor} did not "
                      f"improve for {self.patience} evals")


class ReduceLROnPlateau(Callback):
    """Reference ``callbacks.py`` ReduceLROnPlateau: scale the optimizer lr
    by ``factor`` once the monitored metric plateaus for ``patience``
    evals."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.cooldown_counter = 0
        self.best = np.inf if self.monitor_op == np.less else -np.inf

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.monitor_op(current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter > 0:
            # in cooldown: no plateau counting at all (reference semantics)
            self.cooldown_counter -= 1
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is None:
                    return
                old = float(opt.get_lr())
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:.3e} -> {new:.3e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0
