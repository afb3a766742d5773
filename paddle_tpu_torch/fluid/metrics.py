"""fluid.metrics, the 1.x host-side metric classes (a copy of
paddle_tpu/fluid/metrics.py).  All pure numpy over fetched outputs:
`update(...)` per batch, `eval()` for the aggregate, `reset()` between
passes, Paddle's MetricBase contract.  (The 2.0
paddle.metric package keeps the update/accumulate naming; these
classes keep the legacy update/eval one.)"""

from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall",
           "Accuracy", "ChunkEvaluator", "EditDistance",
           "DetectionMAP", "Auc"]


def _np(x):
    return np.asarray(x)


class MetricBase:
    """Paddle's metrics.py MetricBase:57."""

    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        """Zero every non-underscore-prefixed numeric state attr (the
        Paddle resets via the same attribute walk)."""
        for k, v in list(self.__dict__.items()):
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, type(v)(0))
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    """Bundle several metrics updated with the same inputs
    (Paddle's metrics.py:214)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise TypeError("add_metric expects a MetricBase")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]

    def reset(self):
        for m in self._metrics:
            m.reset()


class Precision(MetricBase):
    """Binary precision over 0/1 preds (Paddle's metrics.py:267)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).reshape(-1)
        labels = _np(labels).reshape(-1)
        self.tp += float(((preds == 1) & (labels == 1)).sum())
        self.fp += float(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).reshape(-1)
        labels = _np(labels).reshape(-1)
        self.tp += float(((preds == 1) & (labels == 1)).sum())
        self.fn += float(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Accuracy(MetricBase):
    """Weighted running accuracy (Paddle's metrics.py:409: feed the
    per-batch accuracy value + batch weight)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if weight < 0:
            raise ValueError("weight must be non-negative")
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError(
                "Accuracy.eval before any update (zero weight)")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Chunking F1 from per-batch chunk counts (Paddle's
    metrics.py:464: feed num_infer_chunks / num_label_chunks /
    num_correct_chunks, e.g. from sequence tagging decode)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(_np(num_infer_chunks).sum())
        self.num_label_chunks += int(_np(num_label_chunks).sum())
        self.num_correct_chunks += int(_np(num_correct_chunks).sum())

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Average edit distance + instance error rate (Paddle's
    metrics.py:541: feed per-batch distances and sequence-error
    counts)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = _np(distances).astype("float64").reshape(-1)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError(
                "EditDistance.eval before any update")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """Streaming ROC AUC via score-threshold histograms (Paddle's
    metrics.py:604 — same stat_pos/stat_neg bucketing)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, "int64")
        self._stat_neg = np.zeros(num_thresholds + 1, "int64")

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.minimum((pos_prob * self._num_thresholds).astype(int),
                         self._num_thresholds)
        lab = labels.astype(bool)
        n = self._num_thresholds + 1
        self._stat_pos += np.bincount(idx[lab], minlength=n)[:n]
        self._stat_neg += np.bincount(idx[~lab], minlength=n)[:n]

    def eval(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            auc += n * (tot_pos + p / 2.0)
            tot_pos += p
            tot_neg += n
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0


class DetectionMAP(MetricBase):
    """Mean average precision for detection (Paddle's metrics.py:682
    exposes the in-graph pipeline; this host-side variant accumulates
    (image_id-free) per-batch detections/ground truths and computes
    11-point or integral AP like Paddle's detection_map op)."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=False, ap_version="integral",
                 class_num=None, **kwargs):
        super().__init__(name)
        assert ap_version in ("integral", "11point")
        self._iou = overlap_threshold
        self._ap_version = ap_version
        self._eval_difficult = evaluate_difficult
        self._dets = []   # (img, cls, score, x1, y1, x2, y2)
        self._gts = []    # (img, cls, difficult, x1, y1, x2, y2)
        self._img = 0

    def update(self, detections, gt_boxes, gt_labels, difficult=None):
        """detections: (N, 6) [cls, score, x1, y1, x2, y2] for ONE
        image; gt_boxes (M, 4); gt_labels (M,)."""
        det = _np(detections).reshape(-1, 6)
        gtb = _np(gt_boxes).reshape(-1, 4)
        gtl = _np(gt_labels).reshape(-1)
        dif = (_np(difficult).reshape(-1) if difficult is not None
               else np.zeros(len(gtl)))
        for row in det:
            self._dets.append((self._img, int(row[0]), float(row[1]),
                               *map(float, row[2:6])))
        for lab, d, box in zip(gtl, dif, gtb):
            self._gts.append((self._img, int(lab), int(d),
                              *map(float, box)))
        self._img += 1

    @staticmethod
    def _iou_of(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def eval(self):
        classes = sorted({g[1] for g in self._gts})
        aps = []
        for c in classes:
            # keep DIFFICULT ground truths matchable: a det matched to
            # one is IGNORED (neither TP nor FP, the VOC protocol);
            # npos counts only non-difficult
            gts = [g for g in self._gts if g[1] == c]
            npos = sum(1 for g in gts
                       if self._eval_difficult or not g[2])
            dets = sorted((d for d in self._dets if d[1] == c),
                          key=lambda d: -d[2])
            matched = set()
            tps, fps = [], []
            for d in dets:
                best, best_iou = None, self._iou
                for gi, g in enumerate(gts):
                    if g[0] != d[0] or gi in matched:
                        continue
                    iou = self._iou_of(d[3:], g[3:])
                    if iou >= best_iou:
                        best, best_iou = gi, iou
                if best is not None:
                    matched.add(best)
                    if not self._eval_difficult and gts[best][2]:
                        continue  # matched a difficult GT: ignored
                    tps.append(1.0)
                    fps.append(0.0)
                else:
                    tps.append(0.0)
                    fps.append(1.0)
            if npos == 0:
                continue
            tp = np.cumsum(tps) if tps else np.array([])
            fp = np.cumsum(fps) if fps else np.array([])
            rec = tp / npos if len(tp) else np.array([0.0])
            prec = (tp / np.maximum(tp + fp, 1e-12)
                    if len(tp) else np.array([0.0]))
            if self._ap_version == "11point":
                ap = np.mean([
                    (prec[rec >= t].max() if (rec >= t).any() else 0.0)
                    for t in np.linspace(0, 1, 11)])
            else:
                mrec = np.concatenate([[0.0], rec, [1.0]])
                mpre = np.concatenate([[0.0], prec, [0.0]])
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(((mrec[idx + 1] - mrec[idx])
                            * mpre[idx + 1]).sum())
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0

    def reset(self):
        self._dets, self._gts, self._img = [], [], 0

    get_map_var = None  # the in-graph pipeline variant is descoped
