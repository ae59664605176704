"""Host-side streaming metrics (counterpart of ``paddle_tpu/metrics.py``:
the v1 gserver/evaluators capability — classification error,
precision/recall, AUC, edit distance — as numpy accumulators over
fetched arrays, outside the program graph)."""
from __future__ import annotations

import numpy as np


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(Metric):
    def __init__(self):
        self.reset()

    def reset(self):
        self.correct = 0.0
        self.total = 0.0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        if preds.ndim > 1 and preds.shape[-1] > 1:
            preds = preds.argmax(-1)
        preds = preds.reshape(-1)
        self.correct += float((preds == labels).sum())
        self.total += labels.size

    def eval(self):
        return self.correct / max(self.total, 1.0)


class Auc(Metric):
    def __init__(self, num_thresholds=200):
        self.n = num_thresholds
        self.reset()

    def reset(self):
        self.pos = np.zeros(self.n + 1)
        self.neg = np.zeros(self.n + 1)

    def update(self, probs, labels):
        probs = np.asarray(probs)
        labels = np.asarray(labels).reshape(-1)
        if probs.ndim == 2 and probs.shape[1] == 2:
            probs = probs[:, 1]
        probs = probs.reshape(-1)
        idx = np.clip((probs * self.n).astype(int), 0, self.n)
        np.add.at(self.pos, idx, labels > 0)
        np.add.at(self.neg, idx, labels <= 0)

    def eval(self):
        tp = np.cumsum(self.pos[::-1])[::-1]
        fp = np.cumsum(self.neg[::-1])[::-1]
        tpr = tp / max(tp[0], 1.0)
        fpr = fp / max(fp[0], 1.0)
        return float(-np.trapezoid(tpr, fpr))


class PrecisionRecall(Metric):
    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.tp = np.zeros(self.num_classes)
        self.fp = np.zeros(self.num_classes)
        self.fn = np.zeros(self.num_classes)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        if preds.ndim > 1 and preds.shape[-1] > 1:
            preds = preds.argmax(-1)
        preds = preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        for c in range(self.num_classes):
            self.tp[c] += float(((preds == c) & (labels == c)).sum())
            self.fp[c] += float(((preds == c) & (labels != c)).sum())
            self.fn[c] += float(((preds != c) & (labels == c)).sum())

    def eval(self):
        prec = self.tp / np.maximum(self.tp + self.fp, 1.0)
        rec = self.tp / np.maximum(self.tp + self.fn, 1.0)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-6)
        return prec.mean(), rec.mean(), f1.mean()


class EditDistance(Metric):
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_dist = 0.0
        self.count = 0

    def update(self, dists):
        d = np.asarray(dists).reshape(-1)
        self.total_dist += float(d.sum())
        self.count += d.size

    def eval(self):
        return self.total_dist / max(self.count, 1)
