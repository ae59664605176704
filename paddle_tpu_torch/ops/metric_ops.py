"""Metric ops (counterpart of ``paddle_tpu/ops/metric_ops.py``):
``accuracy``, ``auc``, ``precision_recall`` and
``positive_negative_pair``.  They run on the tensor's device, inside a
captured step; the streaming state lives in persistable scope vars that
``evaluator`` accumulates."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    """Indices: top-k predicted ids [N, k]; Label [N, 1].  Accuracy is
    fp32, Correct and Total int32, each of shape [1]."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    label = label.to(idx.dtype).reshape(-1, 1)
    correct = (idx == label).any(dim=1)
    num_correct = correct.to(torch.float32).sum()
    n = idx.shape[0]
    return {"Accuracy": (num_correct / float(n)).reshape(1),
            "Correct": num_correct.to(torch.int32).reshape(1),
            "Total": torch.full((1,), n, dtype=torch.int32,
                                device=idx.device)}


@register_op("auc")
def _auc(ctx, ins, attrs):
    """Streaming ROC AUC over ``num_thresholds`` + 1 buckets of the
    positive probability (Predict [N, 2] or [N, 1]); StatPos/StatNeg,
    when given, are added to the batch's histograms first."""
    pred = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    num_thresh = attrs.get("num_thresholds", 200)
    if pred.dim() == 2 and pred.shape[1] == 2:
        pos_prob = pred[:, 1]
    else:
        pos_prob = pred.reshape(-1)
    bucket = torch.clamp((pos_prob * num_thresh).to(torch.int32), 0,
                         num_thresh).to(torch.int64)
    pos = (label > 0).to(torch.float32)
    neg = 1.0 - pos
    zeros = torch.zeros(num_thresh + 1, dtype=torch.float32,
                        device=pred.device)
    tp_hist = zeros.index_add(0, bucket, pos)
    fp_hist = zeros.index_add(0, bucket, neg)
    if ins.get("StatPos"):
        tp_hist = tp_hist + ins["StatPos"][0]
        fp_hist = fp_hist + ins["StatNeg"][0]
    # true and false positives above each threshold: suffix sums
    tp = torch.flip(torch.cumsum(torch.flip(tp_hist, (0,)), 0), (0,))
    fp = torch.flip(torch.cumsum(torch.flip(fp_hist, (0,)), 0), (0,))
    tpr = tp / torch.clamp_min(tp[0], 1.0)
    fpr = fp / torch.clamp_min(fp[0], 1.0)
    auc = -torch.trapezoid(tpr, fpr)
    return {"AUC": auc.reshape(1), "StatPosOut": tp_hist,
            "StatNegOut": fp_hist}


@register_op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    """Per-class true positives, false positives and false negatives of
    the predicted ids (plus StatesInfo), and their macro and micro
    precision, recall and F1."""
    idx = ins["Indices"][0].reshape(-1).to(torch.int64)
    label = ins["Labels"][0].reshape(-1).to(torch.int64)
    ncls = attrs["class_number"]
    zeros = torch.zeros(ncls, dtype=torch.float32, device=idx.device)
    ones = torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device)
    onehot_pred = zeros.index_add(0, idx, ones)
    onehot_lab = zeros.index_add(0, label, ones)
    tp = zeros.index_add(0, idx, (idx == label).to(torch.float32))
    states = torch.stack([tp, onehot_pred - tp, onehot_lab - tp], dim=1)
    if ins.get("StatesInfo"):
        states = states + ins["StatesInfo"][0]
    tp_, fp_, fn_ = states[:, 0], states[:, 1], states[:, 2]
    prec = tp_ / torch.clamp_min(tp_ + fp_, 1.0)
    rec = tp_ / torch.clamp_min(tp_ + fn_, 1.0)
    f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-6)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    tps, fps, fns = tp_.sum(), fp_.sum(), fn_.sum()
    mp = tps / torch.clamp_min(tps + fps, 1.0)
    mr = tps / torch.clamp_min(tps + fns, 1.0)
    mf = 2 * mp * mr / torch.clamp_min(mp + mr, 1e-6)
    metrics = torch.cat([macro, torch.stack([mp, mr, mf])])
    return {"BatchMetrics": metrics, "AccumMetrics": metrics,
            "AccumStatesInfo": states}


@register_op("positive_negative_pair")
def _pnpair(ctx, ins, attrs):
    """Within each query, the pairs whose label order the scores keep
    (positive), tie (neutral) or reverse (negative), plus the
    accumulated counts when given."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    qid = ins["QueryID"][0].reshape(-1)
    valid = (qid[:, None] == qid[None, :]) & (label[:, None] > label[None, :])
    f = torch.float32
    pos = (valid & (score[:, None] > score[None, :])).to(f).sum()
    neu = (valid & (score[:, None] == score[None, :])).to(f).sum()
    neg = valid.to(f).sum() - pos - neu
    if ins.get("AccumulatePositivePair"):
        pos = pos + ins["AccumulatePositivePair"][0].reshape(())
        neg = neg + ins["AccumulateNegativePair"][0].reshape(())
        neu = neu + ins["AccumulateNeutralPair"][0].reshape(())
    return {"PositivePair": pos.reshape(1), "NegativePair": neg.reshape(1),
            "NeutralPair": neu.reshape(1)}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import VarInfo  # noqa: E402
from ..core.registry import register_shape_fn  # noqa: E402


@register_shape_fn("accuracy")
def _accuracy_shape(op, ins, attrs):
    return {"Accuracy": VarInfo((1,), "float32"),
            "Correct": VarInfo((1,), "int32"),
            "Total": VarInfo((1,), "int32")}


@register_shape_fn("auc")
def _auc_shape(op, ins, attrs):
    n = attrs.get("num_thresholds", 200)
    hist = VarInfo((n + 1,), "float32")
    return {"AUC": VarInfo((1,), "float32"), "StatPosOut": hist,
            "StatNegOut": hist}


@register_shape_fn("precision_recall")
def _precision_recall_shape(op, ins, attrs):
    ncls = attrs["class_number"]
    m = VarInfo((6,), "float32")
    return {"BatchMetrics": m, "AccumMetrics": m,
            "AccumStatesInfo": VarInfo((ncls, 3), "float32")}


@register_shape_fn("positive_negative_pair")
def _pnpair_shape(op, ins, attrs):
    s = VarInfo((1,), "float32")
    return {"PositivePair": s, "NegativePair": s, "NeutralPair": s}


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop): metrics reduce to
# scalars and counters, replicated whatever their inputs' sharding.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import shard_replicated  # noqa: E402
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("accuracy")(shard_replicated(
    "Accuracy", "Correct", "Total"))
register_shard_fn("auc")(shard_replicated("AUC"))
register_shard_fn("precision_recall")(shard_replicated(
    "BatchMetrics", "AccumMetrics", "AccumStatesInfo"))
register_shard_fn("positive_negative_pair")(shard_replicated(
    "PositivePair", "NegativePair", "NeutralPair"))
