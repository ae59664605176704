"""Program-state evaluators (counterpart of ``paddle_tpu/evaluator.py``;
reference: fluid/evaluator.py:21-90, the Evaluator base with its state
vars, Accuracy and ChunkEvaluator).

A state is a persistable scope var that the metric ops accumulate, with
``sums``, inside the main program, so a captured step accumulates it
too; ``eval`` reads the states from the scope, and ``reset`` zeroes them
on the scope's device.  ``RankAuc``, ``CTCError`` and ``DetectionMAP``
are host-side numpy evaluators over fetched arrays.  ``ChunkEvaluator``
accumulates the CRF family's ``chunk_eval`` counts the same way as
``Accuracy`` does its own.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.scope import global_scope
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from . import layers


def _scalar(scope, name):
    return float(scope.get(name).reshape(-1)[0].item())


class Evaluator:
    def __init__(self, name, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states = []
        self.metrics = []

    def _create_state(self, suffix, dtype, shape):
        var = self.helper.create_global_variable(
            list(shape), dtype, name=f"{self.helper.name}.{suffix}")
        self.helper.set_variable_initializer(var, ConstantInitializer(0.0))
        self.states.append(var)
        return var

    def reset(self, executor, reset_program=None, scope=None):
        """Zero every state held by ``scope`` (the global scope by
        default), on the device and in the dtype it holds."""
        scope = global_scope() if scope is None else scope
        for s in self.states:
            if scope.has(s.name):
                scope.set(s.name, torch.zeros_like(scope.get(s.name)))

    def eval(self, executor, eval_program=None, scope=None):
        raise NotImplementedError


class Accuracy(Evaluator):
    """Streaming accuracy (fluid evaluator.Accuracy): top-k of ``input``,
    the accuracy op against ``label``, and its Correct and Total (cast
    to fp32) summed into the ``total`` and ``correct`` states each
    step."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy_eval", **kwargs)
        self.total = self._create_state("total", "float32", [1])
        self.correct = self._create_state("correct", "float32", [1])
        topk_out, topk_idx = layers.topk(input, k)
        acc = self.helper.create_variable_for_type_inference("float32", (1,))
        bc = self.helper.create_variable_for_type_inference("int32")
        bt = self.helper.create_variable_for_type_inference("int32")
        self.helper.append_op(
            type="accuracy",
            inputs={"Out": [topk_out], "Indices": [topk_idx],
                    "Label": [label]},
            outputs={"Accuracy": [acc], "Correct": [bc], "Total": [bt]})
        # accumulate into the states
        bcf = layers.cast(bc, "float32")
        btf = layers.cast(bt, "float32")
        layers.sums([self.total, btf], out=self.total)
        layers.sums([self.correct, bcf], out=self.correct)
        self.metrics.append(acc)
        self.batch_accuracy = acc

    def eval(self, executor, eval_program=None, scope=None):
        """correct / total over the steps since the last reset, [1]
        fp32."""
        scope = global_scope() if scope is None else scope
        total = _scalar(scope, self.total.name)
        correct = _scalar(scope, self.correct.name)
        return np.array([correct / max(total, 1.0)], np.float32)


class ChunkEvaluator(Evaluator):
    """Streaming chunk F1 (fluid evaluator.ChunkEvaluator): the
    ``chunk_eval`` op over ``input`` (the inferred tags) and ``label``,
    and its three counts (cast to fp32) summed into the ``num_infer``,
    ``num_label`` and ``num_correct`` states each step; ``metrics`` are
    the batch's precision, recall and F1."""

    def __init__(self, input, label, chunk_scheme="IOB", num_chunk_types=1,
                 **kwargs):
        super().__init__("chunk_eval", **kwargs)
        self.num_infer = self._create_state("num_infer", "float32", [1])
        self.num_label = self._create_state("num_label", "float32", [1])
        self.num_correct = self._create_state("num_correct", "float32", [1])
        prec = self.helper.create_variable_for_type_inference("float32")
        rec = self.helper.create_variable_for_type_inference("float32")
        f1 = self.helper.create_variable_for_type_inference("float32")
        ni = self.helper.create_variable_for_type_inference("int64")
        nl = self.helper.create_variable_for_type_inference("int64")
        nc = self.helper.create_variable_for_type_inference("int64")
        self.helper.append_op(
            type="chunk_eval",
            inputs={"Inference": [input], "Label": [label]},
            outputs={"Precision": [prec], "Recall": [rec], "F1-Score": [f1],
                     "NumInferChunks": [ni], "NumLabelChunks": [nl],
                     "NumCorrectChunks": [nc]},
            attrs={"chunk_scheme": chunk_scheme,
                   "num_chunk_types": num_chunk_types})
        layers.sums([self.num_infer, layers.cast(ni, "float32")],
                    out=self.num_infer)
        layers.sums([self.num_label, layers.cast(nl, "float32")],
                    out=self.num_label)
        layers.sums([self.num_correct, layers.cast(nc, "float32")],
                    out=self.num_correct)
        self.metrics.extend([prec, rec, f1])

    def eval(self, executor, eval_program=None, scope=None):
        """[precision, recall, F1] over the steps since the last reset,
        fp32: correct / inferred, correct / labelled, and their harmonic
        mean."""
        scope = global_scope() if scope is None else scope
        ni = _scalar(scope, self.num_infer.name)
        nl = _scalar(scope, self.num_label.name)
        nc = _scalar(scope, self.num_correct.name)
        p = nc / max(ni, 1.0)
        r = nc / max(nl, 1.0)
        f1 = 2 * p * r / max(p + r, 1e-6)
        return np.array([p, r, f1], np.float32)


class RankAuc:
    """Streaming per-query rank-AUC (reference:
    gserver/evaluators/Evaluator.cpp:513 RankAucEvaluator).

    Each query contributes calcRankAuc(scores, clicks, pv): sort by score
    descending, sweep accumulating click mass vs (pv − click) mass with the
    trapezoid tie-correction for equal scores; AUC = area / (clickSum ·
    noClickSum).  ``eval`` is the mean over queries (the evaluator's
    totalScore/numSamples print).  Host-side streaming by design — metric
    aggregation has no MXU work.

    One deliberate deviation: the reference accumulates ``noClickSum +=
    noClick`` (the running within-tie-group sum), which inflates the
    denominator whenever scores tie and under-reports AUC; here the
    denominator is the exact pair mass clickSum · Σ(pv−click) — bit-identical
    to the reference for all-distinct scores, and the textbook value
    (tied pairs at half credit) under ties.
    """

    def __init__(self):
        self.reset()

    def reset(self, *a, **kw):
        self._total = 0.0
        self._count = 0

    @staticmethod
    def _query_auc(scores, clicks, pv):
        order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
        scores = np.asarray(scores, np.float64)[order]
        clicks = np.asarray(clicks, np.float64)[order]
        pv = np.asarray(pv, np.float64)[order]
        auc = click_sum = old_click_sum = 0.0
        no_click = no_click_sum = 0.0
        last = scores[0] + 1.0
        for s, c, p in zip(scores, clicks, pv):
            if s != last:
                auc += (click_sum + old_click_sum) * no_click / 2.0
                old_click_sum = click_sum
                no_click = 0.0
                last = s
            no_click += p - c
            no_click_sum += p - c
            click_sum += c
        auc += (click_sum + old_click_sum) * no_click / 2.0
        denom = click_sum * no_click_sum
        return auc / denom if denom != 0.0 else 0.0

    def update(self, scores, clicks, pv=None, seq_lens=None):
        """Add one batch.  ``scores``/``clicks`` (and optional ``pv`` page
        views) are flat arrays; ``seq_lens`` splits them into queries
        (whole batch = one query when omitted — the non-sequence case)."""
        scores = np.asarray(scores).reshape(-1)
        clicks = np.asarray(clicks).reshape(-1)
        pv = (np.ones_like(scores) if pv is None
              else np.asarray(pv).reshape(-1))
        bounds = (np.cumsum([0] + list(seq_lens)) if seq_lens is not None
                  else np.array([0, len(scores)]))
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b > a:
                self._total += self._query_auc(scores[a:b], clicks[a:b],
                                               pv[a:b])
                self._count += 1

    def eval(self, *a, **kw):
        return self._total / self._count if self._count else 0.0


class CTCError:
    """Streaming CTC sequence-error evaluator (reference:
    gserver/evaluators/CTCErrorEvaluator.cpp — best-path decode, collapse
    repeats/blanks (blank = num_classes−1, a repeat separated by blank is
    kept), Levenshtein alignment with substitution/deletion/insertion
    backtrace, per-sequence normalization by max(len(gt), len(rec))).

    ``eval`` returns the CER; ``results`` exposes the evaluator's full dict
    (error / deletion_error / insertion_error / substitution_error /
    sequence_error).
    """

    def __init__(self):
        self.reset()

    def reset(self, *a, **kw):
        self._dist = 0.0
        self._del = 0.0
        self._ins = 0.0
        self._sub = 0.0
        self._seq_err = 0
        self._count = 0

    @staticmethod
    def best_path(acts, blank):
        """argmax path → collapsed label string (path2String)."""
        path = np.asarray(acts).argmax(axis=-1)
        out = []
        prev = -1
        for lab in path:
            if lab != blank and (not out or lab != out[-1] or prev == blank):
                out.append(int(lab))
            prev = lab
        return out

    @staticmethod
    def _align(gt, rec):
        """(distance, subs, dels, ins) via Levenshtein backtrace preferring
        diagonal moves (stringAlignment)."""
        n, m = len(gt), len(rec)
        if n == 0:
            return m, 0, 0, m
        if m == 0:
            return n, 0, n, 0
        mat = np.zeros((n + 1, m + 1), np.int64)
        mat[:, 0] = np.arange(n + 1)
        mat[0, :] = np.arange(m + 1)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                cost = 0 if gt[i - 1] == rec[j - 1] else 1
                mat[i, j] = min(mat[i - 1, j] + 1, mat[i, j - 1] + 1,
                                mat[i - 1, j - 1] + cost)
        subs = dels = ins = 0
        i, j = n, m
        while i and j:
            if mat[i, j] == mat[i - 1, j - 1]:
                i -= 1; j -= 1
            elif mat[i, j] == mat[i - 1, j - 1] + 1:
                subs += 1; i -= 1; j -= 1
            elif mat[i, j] == mat[i - 1, j] + 1:
                dels += 1; i -= 1
            else:
                ins += 1; j -= 1
        dels += i
        ins += j
        return subs + dels + ins, subs, dels, ins

    def update(self, activations, labels, blank=None):
        """One sequence: ``activations`` [T, num_classes] (softmax or
        logits — only argmax matters), ``labels`` the ground-truth ids."""
        acts = np.asarray(activations)
        blank = acts.shape[-1] - 1 if blank is None else blank
        rec = self.best_path(acts, blank)
        gt = [int(x) for x in np.asarray(labels).reshape(-1)]
        dist, subs, dels, ins = self._align(gt, rec)
        max_len = max(len(gt), len(rec), 1)
        self._dist += dist / max_len
        self._sub += subs / max_len
        self._del += dels / max_len
        self._ins += ins / max_len
        if dist:
            self._seq_err += 1
        self._count += 1

    def results(self):
        n = max(self._count, 1)
        return {"error": self._dist / n,
                "deletion_error": self._del / n,
                "insertion_error": self._ins / n,
                "substitution_error": self._sub / n,
                "sequence_error": self._seq_err / n}

    def eval(self, *a, **kw):
        return self.results()["error"]


class DetectionMAP:
    """Detection mean-average-precision (reference:
    gserver/evaluators/DetectionMAPEvaluator.cpp; fluid detection_map_op).

    Host-side streaming evaluator over fetched detection outputs — metric
    aggregation has no MXU work, so it stays off-device by design (the
    reference's evaluator also runs on CPU).  Feed it the static-shape
    [N, K, 6] rows from ``layers.detection_output`` ((label, score, x1, y1,
    x2, y2), -1-padded) plus padded ground truth; padding rows (label < 0)
    are ignored.

    ap_version: '11point' (VOC07 interpolation, the v1 default) or
    'integral' (area under the raw PR curve).
    """

    def __init__(self, overlap_threshold=0.5, ap_version="11point",
                 evaluate_difficult=True):
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.evaluate_difficult = evaluate_difficult
        self.reset()

    def reset(self, *a, **kw):
        self._dets = []      # (img_id, label, score, box)
        self._gts = []       # (img_id, label, box, difficult)
        self._img_count = 0

    def update(self, detections, gt_boxes, gt_labels, gt_difficult=None):
        """detections [N,K,6]; gt_boxes [N,M,4]; gt_labels [N,M] (pad<0)."""
        det = np.asarray(detections)
        gtb = np.asarray(gt_boxes)
        gtl = np.asarray(gt_labels)
        if gtl.ndim == 3:
            gtl = gtl[..., 0]
        gtd = (np.zeros_like(gtl, bool) if gt_difficult is None
               else np.asarray(gt_difficult).astype(bool))
        for i in range(det.shape[0]):
            img = self._img_count
            self._img_count += 1
            for row in det[i]:
                if row[0] >= 0:
                    self._dets.append((img, int(row[0]), float(row[1]),
                                       row[2:6].copy()))
            for m in range(gtb.shape[1]):
                if gtl[i, m] >= 0:
                    self._gts.append((img, int(gtl[i, m]), gtb[i, m].copy(),
                                      bool(gtd[i, m])))

    @staticmethod
    def _iou(a, b):
        x1 = max(a[0], b[0]); y1 = max(a[1], b[1])
        x2 = min(a[2], b[2]); y2 = min(a[3], b[3])
        inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
        ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0) + \
            max(b[2] - b[0], 0) * max(b[3] - b[1], 0) - inter
        return inter / ua if ua > 0 else 0.0

    def _ap(self, tp, fp, n_pos):
        if n_pos == 0:
            return None
        tp = np.cumsum(tp).astype(np.float64)
        fp = np.cumsum(fp).astype(np.float64)
        recall = tp / n_pos
        precision = tp / np.maximum(tp + fp, 1e-12)
        if self.ap_version == "11point":
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t].max() if (recall >= t).any() \
                    else 0.0
                ap += p / 11.0
            return ap
        # integral: sum precision deltas over recall steps
        ap = 0.0
        prev_r = 0.0
        for p, r in zip(precision, recall):
            ap += p * (r - prev_r)
            prev_r = r
        return ap

    def eval(self, *a, **kw):
        labels = sorted({g[1] for g in self._gts})
        aps = []
        for c in labels:
            gts = [g for g in self._gts if g[1] == c]
            n_pos = sum(1 for g in gts
                        if self.evaluate_difficult or not g[3])
            dets = sorted((d for d in self._dets if d[1] == c),
                          key=lambda d: -d[2])
            matched = set()
            tp = np.zeros(len(dets)); fp = np.zeros(len(dets))
            for k, (img, _, _, box) in enumerate(dets):
                # VOC protocol: each detection is assigned to its
                # MAX-overlap gt (matched or not); a duplicate hit on an
                # already-claimed gt is a false positive
                best, best_j = 0.0, -1
                for j, (gimg, _, gbox, _) in enumerate(gts):
                    if gimg != img:
                        continue
                    ov = self._iou(box, gbox)
                    if ov > best:
                        best, best_j = ov, j
                if best >= self.overlap_threshold and best_j >= 0:
                    if not self.evaluate_difficult and gts[best_j][3]:
                        pass       # matched a difficult gt: ignored
                    elif best_j not in matched:
                        matched.add(best_j)
                        tp[k] = 1
                    else:
                        fp[k] = 1  # duplicate detection of a claimed gt
                else:
                    fp[k] = 1
            ap = self._ap(tp, fp, n_pos)
            if ap is not None:
                aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
