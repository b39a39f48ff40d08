"""paddle.metric — port of ``paddle_tpu/metric/__init__.py`` (reference
``python/paddle/metric/metrics.py``). The metrics compute in numpy on the
host, exactly as the JAX package's do: a tensor argument (on any device) is
read back first. ``accuracy`` gives a Tensor on its input's device,
``Accuracy.compute`` a host Tensor of the top-k hits."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.tensor import unwrap, wrap
from .async_buffer import AsyncMetricBuffer  # noqa: F401


def _np(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        t = unwrap(x).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(x)

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "AsyncMetricBuffer"]


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """functional top-k accuracy (reference metric/metrics.py accuracy)."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    topk = np.argsort(-pred, axis=-1)[..., :k].reshape(len(lab), -1)
    hit = (topk == lab[:, None]).any(axis=1)
    out = torch.from_numpy(np.asarray(hit.mean(), np.float32))
    if isinstance(input, torch.Tensor):
        out = out.to(input.device)
    return wrap(out)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] > 1:  # one-hot
            l = l.argmax(-1)
        l = l.reshape(-1)
        topk_idx = np.argsort(-p, axis=-1)[..., : self.maxk].reshape(len(l), -1)
        correct = topk_idx == l[:, None]
        return wrap(torch.from_numpy(correct.astype(np.float32)))

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0]
        for i, k in enumerate(self.topk):
            acc_k = c[:, :k].any(axis=1).sum()
            self.total[i] += float(acc_k)
            self.count[i] += num
        res = [t / max(c_, 1) for t, c_ in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        l = _np(labels).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fp += int(np.sum(pred_pos & (l == 0)))

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        l = _np(labels).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fn += int(np.sum(~pred_pos & (l == 1)))

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self.num_thresholds = num_thresholds
        self._name = name or "auc"
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        l = _np(labels).reshape(-1)
        bins = np.round(p * self.num_thresholds).astype(int)
        for b, lab in zip(bins, l):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = tot_neg = auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            auc += self._stat_neg[i] * (tot_pos + self._stat_pos[i] / 2.0)
            tot_pos += self._stat_pos[i]
            tot_neg += self._stat_neg[i]
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name
