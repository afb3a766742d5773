"""`paddle.metric`: streaming metrics (counterpart of
paddle_tpu/metric/__init__.py: Accuracy, Precision, Recall, Auc).

The accumulation is the reference's numpy on the host.  Only
`Accuracy.compute` touches the device: `torch.topk` of the logits and
the comparison with the labels run there, so one (batch, maxk) boolean
array crosses to the host a step instead of the logits.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """x as numpy, moved to the host first when it is a device tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    if hasattr(x, "numpy"):
        return x.numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Optional pre-processing on device outputs before update()."""
        return pred, label


class Accuracy(Metric):
    """top-k accuracy (reference: metric/__init__.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        """(..., maxk) booleans on the host: is the label the i-th of the
        top classes.  They are found where `pred` lives; only the
        booleans cross to the host (one sync on the card)."""
        pred = torch.as_tensor(pred if isinstance(pred, torch.Tensor)
                               else np.asarray(pred))
        label = torch.as_tensor(label if isinstance(label, torch.Tensor)
                                else np.asarray(label)).to(pred.device)
        top = torch.topk(pred.detach(), self.maxk, dim=-1).indices
        if label.ndim == top.ndim and label.shape[-1] == 1:
            label = label.squeeze(-1)
        return _np(top == label[..., None])

    def update(self, correct, *args):
        correct = _np(correct)
        flat = correct.reshape(-1, correct.shape[-1])
        n = flat.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += flat[:, :k].any(-1).sum()
            self.count[i] += n
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = self.total / np.maximum(self.count, 1)
        return float(res[0]) if len(self.topk) == 1 else res.tolist()

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return float(self.tp) / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return float(self.tp) / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over threshold buckets (reference: Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(int), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx[labels == 1], 1)
        np.add.at(self._stat_neg, idx[labels == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name
