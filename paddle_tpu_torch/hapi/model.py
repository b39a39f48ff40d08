"""hapi Model — the high-level train/eval/predict loop; port of
``paddle_tpu/hapi/model.py`` (reference ``python/paddle/hapi/model.py:915``:
``prepare:1499``, ``fit:1574``, ``train_batch:1055``).

The JAX package functionalizes the train/eval functions into cached XLA
executables (``jit.CompiledStep``). The port runs them eagerly: a train
step is ``net.train()``, the forward, the loss, ``backward()``,
``opt.step()``, ``opt.clear_grad()`` — the kernels are launched as the step
runs, and the host runs ahead of the card until something reads a result
back. (A CUDA-graph step waits for ``ROADMAP.md`` A10.)

The Model runs on the current place (``paddle.set_device``; ``gpu:0``
unless the CPU was set — without a card ``fit``, ``evaluate``, ``predict``
and the batch calls raise, as ``to_tensor`` does), where the network's
parameters must lie.

Async pipeline (``fit``/``evaluate``): batches are staged host→device
through ``io.DeviceLoader`` (pinned memory, copies on a side stream, two
batches ahead) and the per-step loss is NOT read back eagerly — device
scalars accumulate in a ``metric.AsyncMetricBuffer`` and the loop fences
only at the first step, every ``log_freq`` steps and at epoch end, so the
host keeps the card's launch queue full. ``logs['loss']`` therefore updates
at fence boundaries (exactly where ``ProgBarLogger`` prints). Host-side
``Metric`` objects still synchronize every step when present, since their
``compute`` runs in numpy (as in the JAX package).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..framework.place import resolve_device
from ..framework.tensor import unwrap, wrap
from ..metric import Metric, _np
from ..nn.layer.layers import Layer
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    """Reference ``hapi/model.py:915``. ``Model(net)`` then
    ``prepare(optimizer, loss, metrics)`` then ``fit/evaluate/predict``."""

    def __init__(self, network, inputs=None, labels=None):
        if not isinstance(network, Layer):
            raise TypeError("network must be a paddle Layer")
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None,
                graph_lint=None, zero=None, remat=None):
        """Reference ``model.py:1499``. ``zero`` (ZeRO sharding of the
        update), ``remat`` (the selective-remat autopilot) and
        ``graph_lint=True`` (the static lint of the compiled step) need
        packages the port does not have yet and raise; ``graph_lint`` None
        or False is accepted (no analysis package: nothing to lint)."""
        if zero:
            raise NotImplementedError(
                "prepare(zero=...) shards the update over a mesh: the port "
                "has no distributed package yet (ROADMAP.md A8)")
        if remat:
            raise NotImplementedError(
                "prepare(remat=...) plans recompute on the analysis package "
                "and the compiled step (ROADMAP.md A9, A10)")
        if graph_lint:
            raise NotImplementedError(
                "prepare(graph_lint=True) lints with the analysis package "
                "(ROADMAP.md A9)")
        self._optimizer = optimizer
        if loss is not None and not (isinstance(loss, Layer) or callable(loss)):
            raise TypeError("loss must be a Layer or callable")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m} is not a paddle Metric")

    def _device(self):
        """The current place, where the network must lie."""
        dev = resolve_device(None)
        for p in self.network.parameters():
            if p.device != dev:
                raise ValueError(
                    f"the network's parameters are on {p.device}, the "
                    f"current place is {dev}: build the network on the "
                    "current place, or set_device its place")
            break
        return dev

    def _compute_loss(self, outputs, labels):
        outs = _to_list(outputs)
        labs = _to_list(labels)
        loss = self._loss(*(outs + labs))
        if isinstance(loss, (list, tuple)):
            loss = wrap(sum(unwrap(l).sum() for l in loss))
        return loss.mean() if loss.ndim > 0 else loss

    # ------------------------------------------------------------------
    # the steps (eager; the JAX package's CompiledSteps at :140-201)
    # ------------------------------------------------------------------
    def _train_step(self, ins, labs, keep_outputs=True):
        """One eager train step: the loss (not read back) and, when
        ``keep_outputs``, the outputs. Without metrics the outputs are let
        go at once: an LM's logits would otherwise stay allocated through
        the next step's forward."""
        net, opt = self.network, self._optimizer
        net.train()
        outputs = net(*ins)
        loss = self._compute_loss(outputs, labs)
        loss.backward()
        opt.step()
        opt.clear_grad()
        outs = [o.detach() for o in _to_list(outputs)] if keep_outputs else []
        return loss.detach(), outs

    def _eval_step(self, ins, labs, keep_outputs=True):
        net = self.network
        net.eval()
        with torch.no_grad():
            outputs = net(*ins)
            loss = (self._compute_loss(outputs, labs)
                    if self._loss is not None else None)
        return loss, _to_list(outputs) if keep_outputs else []

    # ------------------------------------------------------------------
    # batch-level API (reference model.py:1055/:1112/:1160)
    # ------------------------------------------------------------------
    def _split_batch(self, inputs, labels=None):
        dev = self._device()

        def place(x):
            if isinstance(x, torch.Tensor):
                return wrap(unwrap(x).to(dev))
            return wrap(torch.from_numpy(np.array(x)).to(dev))

        return ([place(t) for t in _to_list(inputs)],
                [place(t) for t in _to_list(labels)])

    def train_batch(self, inputs, labels=None, update=True):
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss, ...) before training")
        ins, labs = self._split_batch(inputs, labels)
        loss, outs = self._train_step(ins, labs)
        self._update_metrics(outs, labs)
        return [float(loss)]

    def eval_batch(self, inputs, labels=None):
        ins, labs = self._split_batch(inputs, labels)
        loss, outs = self._eval_step(ins, labs)
        self._update_metrics(outs, labs)
        return [float(loss)] if loss is not None else []

    def predict_batch(self, inputs):
        """The outputs as numpy arrays (a bf16 output as fp32: the card's
        host has no bfloat16 numpy type)."""
        ins, _ = self._split_batch(inputs)
        return self._predict_step(ins)

    def _predict_step(self, ins):
        net = self.network
        net.eval()
        with torch.no_grad():
            out = net(*ins)
        return [_np(o) for o in _to_list(out)]

    def _update_metrics(self, outputs, labels):
        for m in self._metrics:
            args = list(_to_list(outputs)) + list(labels)
            state = m.compute(*args) if hasattr(m, "compute") else args
            m.update(*[_np(s) if isinstance(s, torch.Tensor) else s
                       for s in _to_list(state)])

    # ------------------------------------------------------------------
    # epoch loops (reference model.py:1574 fit / :1743 evaluate / :1852 predict)
    # ------------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, num_workers, drop_last=False):
        from ..io import DataLoader, Dataset

        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset) or hasattr(data, "__getitem__"):
            # host batches: the epoch loop's DeviceLoader stages them
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last,
                              places="cpu")
        return data  # assume iterable of batches

    def _staged(self, loader):
        from ..io.device_loader import DeviceLoader

        return DeviceLoader(loader, device=self._device())

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            resume=None, ckpt_freq=None, keep_last_n=None):
        """Train. ``resume`` (a directory path or a
        ``fault.CheckpointManager``) makes the run fault-tolerant: the
        newest verified checkpoint there is restored (params, optimizer
        accumulators incl. master weights, LR scheduler, every generator,
        data cursor) and training continues from the exact step it stopped
        at; a SIGTERM mid-run flushes a consistent checkpoint and raises
        ``fault.TrainingPreempted``. Checkpoints are written every epoch
        plus every ``ckpt_freq`` steps; ``keep_last_n`` bounds how many are
        kept."""
        assert train_data is not None, "train_data must be given!"
        self._device()
        sess = None
        start_epoch = start_step = 0
        if resume is not None:
            from ..fault import ResumeSession

            sess = ResumeSession(resume, self.network, self._optimizer,
                                 keep_last_n=keep_last_n, ckpt_freq=ckpt_freq)
            start_epoch, start_step = sess.restore()
        loader = self._loader(train_data, batch_size, shuffle, num_workers,
                              drop_last)
        eval_loader = self._loader(eval_data, batch_size, False, num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                save_freq=save_freq, save_dir=save_dir,
                                verbose=verbose,
                                metrics=["loss"] + self._metrics_name())
        self.stop_training = False
        logs = {}
        cbks.on_begin("train")
        try:
            for epoch in range(start_epoch, epochs):
                if sess is not None:
                    # host-RNG snapshot BEFORE the epoch permutation draws
                    sess.epoch_begin(epoch)
                cbks.on_epoch_begin(epoch)
                skip = start_step if (sess is not None
                                      and epoch == start_epoch) else 0
                logs = self._run_one_epoch(loader, cbks, "train", log_freq,
                                           skip_steps=skip, fault_sess=sess,
                                           epoch=epoch)
                if eval_loader is not None and epoch % eval_freq == 0:
                    cbks.on_begin("eval")
                    eval_logs = self._run_one_epoch(eval_loader, cbks, "eval",
                                                    log_freq)
                    cbks.on_end("eval", eval_logs)
                    logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
                cbks.on_epoch_end(epoch, logs)
                if sess is not None:
                    sess.epoch_end(epoch)
                if self.stop_training:
                    break
        finally:
            if sess is not None:
                sess.close()
        cbks.on_end("train", logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        self._device()
        loader = self._loader(eval_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, log_freq=log_freq,
                                verbose=verbose,
                                metrics=["loss"] + self._metrics_name())
        cbks.on_begin("eval")
        logs = self._run_one_epoch(loader, cbks, "eval", log_freq)
        cbks.on_end("eval", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        self._device()
        loader = self._loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose)
        cbks.on_begin("predict")
        outputs = []
        for step, batch in enumerate(self._staged(loader)):
            batch = [wrap(b) for b in _to_list(batch)]
            # labeled datasets: drop the trailing label column(s)
            if self._loss is not None and len(batch) >= 2:
                batch = batch[:-1]
            cbks.on_batch_begin("predict", step)
            outs = self._predict_step(batch)
            outputs.append(outs)
            cbks.on_batch_end("predict", step, {"batch_size": len(batch[0])})
        # transpose list-of-batches -> per-output list
        by_output = list(zip(*outputs)) if outputs else []
        if stack_outputs:
            result = [np.concatenate(o, axis=0) for o in by_output]
        else:
            result = [list(o) for o in by_output]
        cbks.on_end("predict", {})
        return result

    def _metrics_name(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, (list, tuple)) else [n])
        return names

    def _run_one_epoch(self, loader, cbks, mode, log_freq=10, skip_steps=0,
                       fault_sess=None, epoch=0):
        import itertools

        from ..metric import AsyncMetricBuffer
        from ..profiler import telemetry, tracing

        if mode == "train" and (self._optimizer is None or self._loss is None):
            raise RuntimeError("call prepare(optimizer, loss, ...) before training")
        for m in self._metrics:
            m.reset()
        logs = {}
        total_samples = 0
        # async pipeline: batches stage host->device on a side stream;
        # losses stay on the card and fence only at log_freq boundaries +
        # epoch end (metric.AsyncMetricBuffer)
        buf = AsyncMetricBuffer()
        log_freq = max(1, int(log_freq or 1))
        src = iter(loader)
        if skip_steps:
            # mid-epoch resume: the host RNG was rewound to this epoch's
            # start, so this iterator replays the interrupted epoch's exact
            # batch order — discard the already-trained prefix on the host
            for _ in itertools.islice(src, skip_steps):
                pass
        # per-step phase timeline: the flag is global and False by default,
        # so the disabled path does zero telemetry work. step_begin sits
        # BEFORE the for statement (and again at each body end) because the
        # next batch's data_wait happens inside the iterator protocol,
        # between loop bodies.
        tm_on = telemetry.enabled()
        if tm_on:
            telemetry.step_begin()
        # request-scoped tracing, train-side: the epoch roots a trace and
        # every step runs inside a child span
        tr_on = tracing.enabled()
        epoch_span = None
        if tr_on:
            epoch_span = tracing.start_span(
                f"{mode}_epoch", attrs={"epoch": epoch, "mode": mode})
        step_fn = self._train_step if mode == "train" else self._eval_step
        for step, batch in enumerate(self._staged(src), start=skip_steps):
            batch = [wrap(b) for b in _to_list(batch)]
            # convention: trailing element(s) are labels when a loss is set
            if self._loss is not None and len(batch) >= 2:
                ins, labs = batch[:-1], batch[-1:]
            else:
                ins, labs = batch, []
            cbks.on_batch_begin(mode, step, logs)
            with tracing.span(f"{mode}_step", parent=epoch_span,
                              attrs={"step": step}) if tr_on \
                    else tracing.NULL_SPAN:
                # the eager step's host time is the JAX package's dispatch
                # phase: the card runs it after the host has moved on
                with telemetry.phase_span("dispatch"):
                    loss, outs = step_fn(ins, labs,
                                         keep_outputs=bool(self._metrics))
            buf.append(loss)
            # fence at log_freq boundaries; also once at the first step so
            # logs['loss'] exists from the first callback onward (between
            # fences it holds the last drained value)
            if step == skip_steps or (step + 1) % log_freq == 0:
                buf.drain()  # fence: flush pending device losses to host
            if buf.values:
                logs["loss"] = buf.last()
            if self._metrics:
                # host-side numpy metrics force a per-step sync; only paid
                # when the user actually configured metrics
                self._update_metrics(outs, labs)
                for m in self._metrics:
                    res = m.accumulate()
                    for name, v in zip(_to_list(m.name()), _to_list(res)):
                        logs[name] = v
            total_samples += ins[0].shape[0]
            cbks.on_batch_end(mode, step, logs)
            if fault_sess is not None and mode == "train":
                # AFTER on_batch_end: the LRScheduler callback has stepped,
                # so a checkpoint here captures the post-step boundary
                # exactly; raises TrainingPreempted after a SIGTERM flush
                fault_sess.after_step(epoch, step + 1)
            if tm_on:
                telemetry.step_begin()  # roll the phase record over
        buf.drain()  # epoch-end fence
        if epoch_span is not None:
            epoch_span.set_attr("samples", total_samples).end()
        if tm_on:
            telemetry.step_end()
        if buf.values:
            logs["loss"] = buf.last()
        if mode == "eval":
            logs["eval_samples"] = total_samples
        return dict(logs)

    # ------------------------------------------------------------------
    # persistence / introspection
    # ------------------------------------------------------------------
    def save(self, path, training=True):
        """Reference ``model.py:1932``: <path>.pdparams (+ .pdopt), in the
        JAX package's format."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        from ..framework.io import save as psave

        psave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as pload

        self.network.set_state_dict(pload(path + ".pdparams"))
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(pload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def device_report(self):
        """The JAX package returns the compiled step's device cost report
        (``profiler/devprof``), which the port does not have yet."""
        raise NotImplementedError(
            "device_report() reads profiler/devprof, which the port does not "
            "have yet (ROADMAP.md A6)")

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary

        return summary(self.network, input_size, dtypes=dtype)
