"""Loss functionals — port of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy`` and the routes it takes, ``mse_loss``, ``l1_loss``, the
binary, negative log-likelihood, divergence, regression, margin, embedding
and focal losses, ``ctc_loss``, ``hsigmoid_loss`` and
``margin_cross_entropy``), in plain PyTorch.

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

The other losses are ops of the port's registry under the JAX op names
(``bce_op``, ``bce_logits_op``, ``nll_loss_op``, ``kl_div_op``,
``smooth_l1_op``, ``sigmoid_focal_op``, ...), with the JAX package's
formulas where PyTorch's function of the same name differs:
``smooth_l1_loss(delta)`` is the Huber loss (``0.5 d^2`` below ``delta``,
else ``delta (|d| - delta / 2)``; torch's divides by its ``beta``),
``kl_div``'s ``"batchmean"`` divides by the batch and ``"mean"`` averages
every element, ``sigmoid_focal_loss`` sums by default and divides by
``normalizer``. ``binary_cross_entropy`` with a ``weight`` multiplies the
loss by it (the JAX package raises a ``TypeError`` there, ``ROADMAP.md``
C).

``ctc_loss`` (the JAX op ``ctc_op``, black list) takes raw logits ``[T, B,
C]``, applies ``log_softmax`` itself, as the JAX package (and Paddle's
warpctc) do, and runs PyTorch's CTC on the result (``"mean"`` divides each
loss by its label length first); ``norm_by_times`` divides each sequence's
gradient by its input length and leaves the loss as it is, as Paddle
documents it (the JAX package drops the flag; ``ROADMAP.md`` C).
``hsigmoid_loss`` walks the default complete binary tree (internal nodes
heap-indexed, Paddle's ``SimpleCode``) or a caller's ``path_table`` /
``path_code`` and sums a binary cross entropy a node; its weight gradient
is dense (``is_sparse`` too, as ``F.embedding(sparse=True)``).
``margin_cross_entropy`` is ArcFace's combined margin on cosine logits, on
one card (``group`` raises, naming ``ROADMAP.md`` A8).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...ops import math as _math
from ...ops.dispatch import apply_op, op, plain, scalar_like
from . import common as _common

__all__ = ["cross_entropy", "mse_loss", "l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "nll_loss", "kl_div",
           "smooth_l1_loss", "huber_loss", "margin_ranking_loss",
           "hinge_embedding_loss", "cosine_embedding_loss",
           "triplet_margin_loss", "triplet_margin_with_distance_loss",
           "square_error_cost", "sigmoid_focal_loss", "log_loss",
           "multi_label_soft_margin_loss", "softmax_with_cross_entropy",
           "npair_loss", "dice_loss", "ctc_loss", "hsigmoid_loss",
           "margin_cross_entropy"]


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


def mse_loss(input, label, reduction="mean", name=None):
    """``paddle.nn.functional.mse_loss``: the squared difference, reduced
    (``amp`` hook ``mse_loss_op``)."""
    input, label = _amp_cast("mse_loss_op", input, label)
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    """``paddle.nn.functional.l1_loss``: the absolute difference, reduced
    (``amp`` hook ``l1_loss_op``)."""
    input, label = _amp_cast("l1_loss_op", input, label)
    return _reduce(torch.abs(input - label), reduction)


_softmax_ce_op = op("softmax_ce")(_softmax_ce)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-sample loss with ``axis`` kept (size 1); with
    ``return_softmax`` also the softmax."""
    axis = int(axis)
    loss = _softmax_ce_op(logits, label, soft_label, axis, ignore_index,
                          "none", 0.0).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis)
    return loss


_nll_op = op("nll_loss_op")(_nll)


@op("nll_loss_weighted")
def _nll_weighted_raw(logp, label, weight, ignore_index=-100,
                      reduction="mean"):
    safe = _safe(label, ignore_index)
    picked = -_pick(logp, safe, 1)
    w = weight[safe.long()] * (label != ignore_index).to(logp.dtype)
    loss = picked * w
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(w.sum(), 1e-12)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` (classes on
    axis 1); ``"mean"`` divides by the kept labels' count, or by their
    summed ``weight``."""
    if weight is not None:
        return _nll_weighted_raw(input, label, weight,
                                 ignore_index=ignore_index,
                                 reduction=reduction)
    return _nll_op(input, label, ignore_index=ignore_index,
                   reduction=reduction)


@op("bce_op")
def _bce_raw(input, label, weight=None, reduction="mean", eps=1e-12):
    loss = -(label * torch.log(torch.clamp_min(input, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    if weight is not None:
        return _bce_raw(input, label, weight, reduction=reduction)
    return _bce_raw(input, label, reduction=reduction)


def _bce_logits(logit, label, pos_weight=None):
    max_val = torch.clamp_min(-logit, 0)
    soft = torch.log1p(torch.exp(-torch.abs(logit))) + max_val
    if pos_weight is not None:
        soft = ((pos_weight - 1.0) * label + 1.0) * soft
    return (1 - label) * logit + soft


@op("bce_logits_op")
def _bce_logits_raw(logit, label, reduction="mean"):
    return _reduce(_bce_logits(logit, label), reduction)


@op("bce_logits_w")
def _bce_logits_w(logit, label, weight, reduction="mean"):
    return _reduce(_bce_logits(logit, label) * weight, reduction)


@op("bce_logits_p")
def _bce_logits_p(logit, label, pos_weight, reduction="mean"):
    return _reduce(_bce_logits(logit, label, pos_weight), reduction)


@op("bce_logits_full")
def _bce_logits_full(logit, label, weight, pos_weight, reduction="mean"):
    return _reduce(_bce_logits(logit, label, pos_weight) * weight, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``pos_weight`` scales the positive term, ``weight`` the whole loss
    (the JAX package's four ops, one for each combination)."""
    if weight is not None and pos_weight is not None:
        return _bce_logits_full(logit, label, weight, pos_weight,
                                reduction=reduction)
    if weight is not None:
        return _bce_logits_w(logit, label, weight, reduction=reduction)
    if pos_weight is not None:
        return _bce_logits_p(logit, label, pos_weight, reduction=reduction)
    return _bce_logits_raw(logit, label, reduction=reduction)


@op("kl_div_op")
def _kl_raw(input, label, reduction="mean"):
    loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(label) - input)``, ``input`` log-probabilities."""
    return _kl_raw(input, label, reduction=reduction)


@op("smooth_l1_op")
def _smooth_l1_raw(input, label, reduction="mean", delta=1.0):
    d = input - label
    ad = torch.abs(d)
    loss = torch.where(ad < delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """The Huber loss of ``input - label`` (module docstring)."""
    return _smooth_l1_raw(input, label, reduction=reduction, delta=delta)


def huber_loss(input, label, delta=1.0, reduction="mean"):
    return _smooth_l1_raw(input, label, reduction=reduction, delta=delta)


@op("margin_ranking_op")
def _margin_ranking_raw(input, other, label, margin=0.0, reduction="mean"):
    return _reduce(torch.clamp_min(
        -label * (input - other) + scalar_like(margin, input), 0), reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _margin_ranking_raw(input, other, label, margin=margin,
                               reduction=reduction)


@op("hinge_embedding_op")
def _hinge_embedding_raw(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1.0, input,
                       torch.clamp_min(margin - input, 0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _hinge_embedding_raw(input, label, margin=margin,
                                reduction=reduction)


@op("cosine_embedding_op")
def _cosine_embedding_raw(input1, input2, label, margin=0.0,
                          reduction="mean"):
    norms = (torch.linalg.vector_norm(input1, dim=-1)
             * torch.linalg.vector_norm(input2, dim=-1))
    cos = torch.sum(input1 * input2, -1) / (norms + 1e-12)
    loss = torch.where(label == 1, 1 - cos,
                       torch.clamp_min(cos - scalar_like(margin, cos), 0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    return _cosine_embedding_raw(input1, input2, label, margin=margin,
                                 reduction=reduction)


@op("triplet_margin_op")
def _triplet_raw(anchor, positive, negative, margin=1.0, p=2.0, eps=1e-6,
                 swap=False, reduction="mean"):
    def dist(a, b):
        return torch.sum(torch.abs(a - b + eps) ** p, dim=-1) ** (1.0 / p)

    d_pos = dist(anchor, positive)
    d_neg = dist(anchor, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    return _triplet_raw(input, positive, negative, margin=margin, p=p,
                        eps=epsilon, swap=swap, reduction=reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet loss under ``distance_function`` (default: the L2
    distance, ``sqrt(sum((u - v)^2) + 1e-12)``)."""
    if distance_function is not None:
        dp = distance_function(input, positive)
        dn = distance_function(input, negative)
        if swap:
            dn = _math.minimum(dn, distance_function(positive, negative))
        loss = _math.clip(dp - dn + margin, min=0.0)
        if reduction == "none":
            return loss
        return _math.sum(loss) if reduction == "sum" else _math.mean(loss)

    def fwd(a, p, n):
        def dist(u, v):
            return torch.sqrt(torch.sum((u - v) ** 2, dim=-1) + 1e-12)

        dp, dn = dist(a, p), dist(a, n)
        if swap:
            dn = torch.minimum(dn, dist(p, n))
        return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)

    return apply_op("triplet_margin_with_distance_loss", fwd,
                    (input, positive, negative), {})


@op("square_error_cost_op")
def square_error_cost(input, label):
    return torch.square(input - label)


def _focal(logit, label, gamma, alpha):
    p = torch.sigmoid(logit)
    ce = (torch.clamp_min(logit, 0) - logit * label
          + torch.log1p(torch.exp(-torch.abs(logit))))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    return a_t * ((1 - p_t) ** gamma) * ce


@op("sigmoid_focal_op")
def _sigmoid_focal_raw(logit, label, gamma=2.0, alpha=0.25, reduction="sum"):
    return _reduce(_focal(logit, label, gamma, alpha), reduction)


@op("sigmoid_focal_n")
def _sigmoid_focal_n(logit, label, normalizer, gamma=2.0, alpha=0.25,
                     reduction="sum"):
    return _reduce(_focal(logit, label, gamma, alpha) / normalizer,
                   reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """The focal loss, summed by default, each term over ``normalizer``."""
    if normalizer is not None:
        return _sigmoid_focal_n(logit, label, normalizer, gamma=gamma,
                                alpha=alpha, reduction=reduction)
    return _sigmoid_focal_raw(logit, label, gamma=gamma, alpha=alpha,
                              reduction=reduction)


@op("log_loss_op")
def _log_loss_raw(input, label, epsilon=1e-4):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def log_loss(input, label, epsilon=1e-4, name=None):
    return _log_loss_raw(input, label, epsilon=epsilon)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    """Per-class soft-margin binary cross entropy, averaged over the
    classes."""
    def fwd(x, y, w=None):
        ls = torch.nn.functional.logsigmoid
        per = -(y * ls(x) + (1.0 - y) * ls(-x))
        if w is not None:
            per = per * w
        return _reduce(per.mean(-1), reduction)

    args = (input, label) if weight is None else (input, label, weight)
    return apply_op("multi_label_soft_margin_loss", fwd, args, {})


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Soft-label cross entropy of the anchor-positive similarities (the
    targets: equal labels, each row normalised) plus ``l2_reg / 4`` times
    the mean squared norms of both embeddings."""
    sim = _common.matmul(anchor, positive, transpose_y=True)
    lab = labels.reshape(-1, 1)
    tgt = (lab == lab.t()).to(sim.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    ce = cross_entropy(sim, tgt, soft_label=True)
    a, p = _amp_cast("square", anchor, positive)
    l2 = (torch.square(a).sum(1).mean() + torch.square(p).sum(1).mean())
    return ce + l2 * (l2_reg * 0.25)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - 2 |X n Y| / (|X| + |Y| + epsilon)`` over each sample, averaged;
    ``label`` holds class ids ``[..., 1]``."""
    lab = _common.one_hot(label.squeeze(-1), input.shape[-1])
    axes = tuple(range(1, input.ndim))
    inter = torch.sum(input * lab, dim=axes)
    (x,) = _amp_cast("sum", input)
    union = torch.sum(x, dim=axes) + torch.sum(lab, dim=axes)
    dice = inter * 2.0 / (union + epsilon)
    return torch.mean(1.0 - dice)


class _GradScale(torch.autograd.Function):
    """``x`` forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        return g * scale, None


@op("ctc_op")
def _ctc_raw(logits, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    logp = torch.log_softmax(logits.float(), -1)
    ilen, llen = input_lengths.long(), label_lengths.long()
    loss = torch.nn.functional.ctc_loss(
        logp, labels.long(), ilen, llen, blank=blank, reduction="none")
    if norm_by_times:
        loss = _GradScale.apply(loss, 1.0 / ilen.clamp_min(1).to(loss.dtype))
    if reduction == "mean":
        loss = (loss / llen.clamp_min(1).to(loss.dtype)).mean()
    else:
        loss = _reduce(loss, reduction)
    return loss.to(logits.dtype)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of raw logits ``log_probs`` ``[T, B, C]`` (normalised here)
    against ``labels`` ``[B, S]`` (padded; ``label_lengths`` long), each
    sequence ``input_lengths`` steps long."""
    return _ctc_raw(log_probs, labels, input_lengths, label_lengths,
                    blank=blank, reduction=reduction,
                    norm_by_times=bool(norm_by_times))


@functools.lru_cache(maxsize=2)
def _default_tree(num_classes):
    """The root-to-leaf internal nodes (-1 past a short path) and codes
    (1: right child) of each class's leaf, heap position ``c +
    num_classes - 1``: built on the host once a class count, as whole
    arrays. In 1-based heap numbering ``v`` of a leaf at depth
    ``L``, its ancestor at depth ``i`` is ``v >> (L - i)`` and the branch
    taken below it is bit ``L - i - 1`` of ``v``."""
    depth = max(1, math.ceil(math.log2(max(2, num_classes))))
    v = np.arange(num_classes, dtype=np.int64) + num_classes
    leaf_depth = np.frexp(v.astype(np.float64))[1].astype(np.int64) - 1
    i = np.arange(depth)[:, None]
    on = i < leaf_depth
    shift = np.where(on, leaf_depth - i, 1)
    tab = np.where(on, (v >> shift) - 1, -1).astype(np.int32).T
    code = np.where(on, (v >> (shift - 1)) & 1, 0).astype(np.float32).T
    return np.ascontiguousarray(tab), np.ascontiguousarray(code)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """``[N, 1]``: a sample's sum over its label's path of
    ``softplus(z) - code * z``, ``z = x . weight[node] + bias[node]``."""
    if path_table is None:
        tab, code = _default_tree(int(num_classes))
        tab, code = torch.from_numpy(tab), torch.from_numpy(code)
    else:
        tab, code = (plain(t) if isinstance(t, torch.Tensor)
                     else torch.as_tensor(np.asarray(t))
                     for t in (path_table, path_code))

    def fwd(x, y, w, b=None):
        y = y.reshape(-1).long()
        nodes = tab.to(x.device)[y].long()
        codes = code.to(x.device)[y].to(x.dtype)
        valid = (nodes >= 0).to(x.dtype)
        safe = nodes.clamp_min(0)
        # embedding's gather: its backward sums the rows' gradients in one
        # sorted pass, where indexing's scatters them one by one
        logits = torch.einsum("nf,ndf->nd", x,
                              torch.nn.functional.embedding(safe, w))
        if b is not None:
            logits = logits + torch.nn.functional.embedding(
                safe, b.reshape(-1, 1)).squeeze(-1)
        per = torch.nn.functional.softplus(logits) - codes * logits
        return (per * valid).sum(-1, keepdim=True)

    args = (input, label, weight) + (() if bias is None else (bias,))
    return apply_op("hsigmoid_loss", fwd, args, {})


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace's combined margin: the label's cosine ``cos(t)`` becomes
    ``cos(margin1 t + margin2) - margin3``, every logit is scaled by
    ``scale``, then softmax cross entropy (``"none"``: ``[N, 1]``)."""
    if group is not None:
        raise NotImplementedError(
            "margin_cross_entropy(group=...): the model-parallel class split "
            "waits for the distributed port (ROADMAP.md A8)")

    def fwd(lg, y):
        y = y.reshape(-1).long()
        theta = torch.arccos(torch.clamp(lg, -1.0 + 1e-7, 1.0 - 1e-7))
        target = torch.cos(margin1 * theta + margin2) - margin3
        onehot = torch.nn.functional.one_hot(y, lg.shape[1]).to(lg.dtype)
        adj = (lg * (1.0 - onehot) + target * onehot) * scale
        loss = torch.logsumexp(adj, -1) - (adj * onehot).sum(-1)
        out = loss[:, None] if reduction == "none" else _reduce(loss,
                                                               reduction)
        return (out, torch.softmax(adj, -1)) if return_softmax else out

    return apply_op("margin_cross_entropy", fwd, (logits, label), {})
