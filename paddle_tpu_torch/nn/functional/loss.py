"""Loss functionals — port of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy`` and the routes it takes), in plain PyTorch.

``cross_entropy`` has the JAX package's three routes, each behind the
``amp`` hook of its JAX op names (all on the black list, so they run in
fp32 under ``auto_cast``):

* softmax + hard or soft labels (``softmax_ce``): log-softmax, the label's
  log-probability picked along ``axis``; ``ignore_index`` zeroes a hard
  label's loss and leaves it out of the mean. ``label_smoothing`` smooths
  soft labels only, as in the JAX package;
* a per-class ``weight`` (``log_softmax_op``, then ``weighted_nll``): the
  mean divides by the summed weights of the kept labels;
* ``use_softmax=False`` (``log``, then ``soft_nll``, ``weighted_nll`` or
  ``nll_loss_op``): the input is already probabilities.

A hard label with as many dims as the input is squeezed along ``axis``
first (paddle's ``[N, 1]`` labels). The result of ``reduction="none"`` has
the squeezed label's shape.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast

__all__ = ["cross_entropy"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _safe(lab, ignore_index):
    """Labels as gather indices: negative or ignored ones read class 0
    (their loss is dropped afterwards)."""
    return torch.where((lab < 0) | (lab == ignore_index), 0, lab)


def _pick(logp, safe, axis):
    """``logp``'s entries at ``safe`` along ``axis`` (take_along_axis)."""
    idx = safe.long().unsqueeze(axis)
    return torch.gather(logp, axis, idx).squeeze(axis)


def _softmax_ce(logits, label, soft_label, axis, ignore_index, reduction,
                ls_epsilon):
    logits, label = _amp_cast("softmax_ce", logits, label)
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        tgt = label
        if ls_epsilon > 0.0:
            n = logits.shape[axis]
            tgt = (1 - ls_epsilon) * tgt + ls_epsilon / n
        return _reduce(-(tgt * logp).sum(axis), reduction)
    lab = label
    if lab.ndim == logp.ndim:
        lab = lab.squeeze(axis)
    loss = -_pick(logp, _safe(lab, ignore_index), axis)
    keep = lab != ignore_index
    loss = torch.where(keep, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(keep.sum(), 1)
    return _reduce(loss, reduction)


def _weighted_nll(logp, label, weight, ignore_index, reduction, axis):
    logp, label, weight = _amp_cast("weighted_nll", logp, label, weight)
    safe = _safe(label, ignore_index)
    picked = -_pick(logp, safe, axis)
    w = weight[safe.long()]
    keep = (label != ignore_index).to(logp.dtype)
    loss = picked * w * keep
    if reduction == "mean":
        return loss.sum() / torch.clamp_min((w * keep).sum(), 1e-12)
    return _reduce(loss, reduction)


def _nll(logp, label, ignore_index, reduction):
    """``nll_loss`` (class axis 1)."""
    logp, label = _amp_cast("nll_loss_op", logp, label)
    picked = -_pick(logp, _safe(label, ignore_index), 1)
    keep = (label != ignore_index).to(logp.dtype)
    loss = picked * keep
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(keep.sum(), 1.0)
    return _reduce(loss, reduction)


def _nll_from_probs(probs, label, weight, ignore_index, reduction,
                    soft_label, axis):
    (probs,) = _amp_cast("log", probs)
    logp = torch.log(probs)
    if soft_label:
        logp, label = _amp_cast("soft_nll", logp, label)
        return _reduce(-(label * logp).sum(axis), reduction)
    if weight is not None:
        return _weighted_nll(logp, label, weight, ignore_index, reduction,
                             axis)
    return _nll(logp, label, ignore_index, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """``paddle.nn.functional.cross_entropy`` over ``input``'s ``axis``
    (see the module docstring). ``name`` is accepted and ignored, as in the
    JAX package."""
    axis = int(axis)
    if not use_softmax:
        return _nll_from_probs(input, label, weight, ignore_index, reduction,
                               soft_label, axis)
    if weight is not None:
        (x,) = _amp_cast("log_softmax_op", input)
        logp = torch.log_softmax(x, dim=axis)
        lab = label.squeeze(axis) if label.ndim == input.ndim else label
        return _weighted_nll(logp, lab, weight, ignore_index, reduction,
                             axis)
    return _softmax_ce(input, label, soft_label, axis, ignore_index,
                       reduction, label_smoothing)
