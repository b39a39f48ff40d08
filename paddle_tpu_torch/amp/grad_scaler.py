"""GradScaler — port of ``paddle_tpu/amp/grad_scaler.py`` (``AmpScaler``,
``GradScaler``).

The scaler multiplies the loss by the scale, divides the gradients by it
before the optimizer step (``unscale_``: ``1 / scale`` in fp32, cast to each
gradient's dtype, as the JAX package does) and skips the step when a
gradient is not finite; ``update`` then adapts the scale (dynamic loss
scaling: ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps, never
below 1, ``incr_ratio`` after ``incr_every_n_steps`` good ones).

The skip is decided before the update. The JAX scaler runs the step and
then selects the pre-step arrays, which it keeps by reference; the port's
optimizer writes parameters in place, and keeping copies would cost the
size of every parameter, master weight and moment each step. So
``found_inf`` is computed on the device and read once a step (one
synchronisation); a step without an inf or nan is the plain
``optimizer.step()``, and a skipped one is ``optimizer._step(apply=False)``,
which leaves the state as JAX's select does: the step count advances,
parameters and existing accumulators keep their values (in the dtype the
rule gives them), and accumulators born in the step hold their fill, a
pending ``set_state_dict`` entry, or for a master weight the parameter.

Scale, good and bad step counts live on the host (fp32 arithmetic through
numpy), so ``state_dict`` needs no synchronisation; its keys are the JAX
scaler's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["AmpScaler", "GradScaler"]


def _f32(v):
    return float(np.float32(v))


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = _f32(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        # a 0-d bool tensor on the gradients' device after unscale_, or False
        self._found_inf = False
        # optimizers already unscaled this step (the documented
        # `scaler.unscale_(opt); clip; scaler.step(opt)` recipe must not
        # divide twice)
        self._unscaled = set()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * torch.tensor(self._scale, dtype=torch.float32)

    def unscale_(self, optimizer):
        if not self._enable or id(optimizer) in self._unscaled:
            return
        inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
            self._scale, dtype=torch.float32)
        flags = []
        with torch.no_grad():
            for p in optimizer._parameter_list:
                if p.grad is None:
                    continue
                p.grad.mul_(inv.to(p.grad.dtype))
                flags.append(torch.isfinite(p.grad).all())
        self._found_inf = (torch.logical_not(torch.stack(flags).all())
                           if flags else False)
        self._unscaled.add(id(optimizer))

    def minimize(self, optimizer, loss, *args, **kwargs):
        loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        self._found_inf = bool(self._found_inf)   # the one sync a step
        with torch.no_grad():
            optimizer._step(apply=not self._found_inf)

    def update(self):
        self._unscaled.clear()
        if not (self._enable and self._dynamic):
            return
        found = bool(self._found_inf)
        bad = self._bad_steps + 1 if found else 0
        good = 0 if found else self._good_steps + 1
        if bad >= self._decr_every_n:
            self._scale = max(_f32(self._scale * self._decr_ratio), 1.0)
            bad = 0
        if good >= self._incr_every_n_steps:
            self._scale = _f32(self._scale * self._incr_ratio)
            good = 0
        self._bad_steps, self._good_steps = bad, good
        self._found_inf = False

    # -- scale accessors (reference API) -------------------------------------
    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = _f32(v)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v):
        self._incr_ratio = v

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v):
        self._decr_ratio = v

    def get_incr_every_n_steps(self):
        return self._incr_every_n_steps

    def set_incr_every_n_steps(self, v):
        self._incr_every_n_steps = v

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every_n

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every_n = v

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, sd):
        """Takes this scaler's ``state_dict()`` or the JAX scaler's (the same
        keys); restores the scale and the step counts, as the JAX package
        does."""
        self._scale = _f32(sd.get("scale", self._scale))
        self._good_steps = int(sd.get("good_steps", 0))
        self._bad_steps = int(sd.get("bad_steps", 0))


class GradScaler(AmpScaler):
    pass
