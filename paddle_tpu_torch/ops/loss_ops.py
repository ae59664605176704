"""Loss ops (counterpart of ``paddle_tpu/ops/loss_ops.py``: every op it
registers).  Each computes in its operands' dtype, as the JAX lowerings
do; ``lambda_rank`` and ``cross_entropy_over_beam`` compute in fp32."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    y = 2.0 * labels.to(logits.dtype) - 1.0
    return {"Loss": torch.clamp_min(1.0 - y * logits, 0.0)}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    a = r.abs()
    loss = torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))
    return {"Out": loss, "Residual": r}


@register_op("log_loss")
def _log_loss(ctx, ins, attrs):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    loss = -label * torch.log(p + eps) \
        - (1.0 - label) * torch.log(1.0 - p + eps)
    return {"Loss": loss}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    """max(0, -label * (x1 - x2) + margin)."""
    x1, x2, label = ins["X1"][0], ins["X2"][0], ins["Label"][0]
    m = attrs.get("margin", 0.0)
    out = torch.clamp_min(-label * (x1 - x2) + m, 0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    """RankNet's pairwise loss: log(1 + exp(d)) - label * d, d the
    difference of the two scores."""
    label, left, right = ins["Label"][0], ins["Left"][0], ins["Right"][0]
    d = left - right
    return {"Out": torch.logaddexp(d, torch.zeros_like(d)) - label * d}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    if ins.get("InsideWeight"):
        d = d * ins["InsideWeight"][0]
    a = d.abs()
    loss = torch.where(a < 1.0 / s2, 0.5 * s2 * d * d, a - 0.5 / s2)
    if ins.get("OutsideWeight"):
        loss = loss * ins["OutsideWeight"][0]
    out = loss.reshape(loss.shape[0], -1).sum(dim=1, keepdim=True)
    return {"Out": out, "Diff": d}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    d = x - y
    out = (d * d).reshape(d.shape[0], -1).sum(dim=1, keepdim=True)
    return {"Out": out, "sub_result": d}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs):
    """The stable form max(x, 0) - x z + log(1 + exp(-|x|))."""
    x, label = ins["X"][0], ins["Label"][0]
    loss = torch.clamp_min(x, 0.0) - x * label \
        + torch.log1p(torch.exp(-x.abs()))
    return {"Out": loss}


@register_op("modified_huber_loss")
def _modified_huber(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    z = (2.0 * y - 1.0) * x
    loss = torch.where(z >= 1.0, torch.zeros_like(z),
                       torch.where(z >= -1.0, (1.0 - z) * (1.0 - z),
                                   -4.0 * z))
    return {"Out": loss, "IntermediateVal": z}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(dim=-1, keepdim=True))
    out = (x * y).sum(dim=-1, keepdim=True) / torch.clamp_min(xn * yn, 1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[:, k] = x W[k] y^T, row by row (+ Bias); W [K, dx, dy]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("nd,kde,ne->nk", x, w, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": out}


@register_op("mse_loss")
def _mse_loss(ctx, ins, attrs):
    """Elementwise squared difference (``loss_ops.py:122-125``)."""
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": d * d}


@register_op("kldiv_loss")
def _kldiv_loss(ctx, ins, attrs):
    """target * (log target - x), elementwise (``reduction`` is recorded
    and, as in the JAX op, not applied)."""
    x, target = ins["X"][0], ins["Target"][0]
    return {"Loss": target * (torch.log(torch.clamp_min(target, 1e-12))
                              - x)}


# ---------------------------------------------------------------------------
# LambdaRank (v1 lambda_cost), over padded query groups
# ---------------------------------------------------------------------------
def _lambda_rank_groups(o, s, n, k, max_sort_size):
    """Padded query groups at once (``loss_ops.py:137-184``, a group a
    row).  o: scores [B, M]; s: relevance labels [B, M]; n: valid counts
    [B].  Returns (NDCG@k [B], the lambda gradient with respect to o
    [B, M]): items ordered by label, descending; the 1 / ln(i + 2)
    position discounts; lambda_ij = -|dcgDif| / (1 + exp(o_i - o_j)),
    normalized by the ideal DCG; the gain 2^label - 1."""
    B, M = o.shape
    pos = torch.arange(M, device=o.device)
    valid = pos[None, :] < n[:, None]
    neg = torch.full_like(o, -3.4e38)
    s_key = torch.where(valid, s, neg)
    o_key = torch.where(valid, o, neg)
    disc = 1.0 / torch.log(pos.to(torch.float32) + 2.0)
    topk = (pos[None, :] < k) & valid
    zero = torch.zeros_like(o)

    idx_l = torch.argsort(-s_key, dim=1, stable=True)   # label-desc order
    s_sorted = torch.gather(s, 1, idx_l)
    o_sorted = torch.gather(o, 1, idx_l)
    gain_sorted = torch.exp2(s_sorted) - 1.0
    max_dcg = torch.where(topk, gain_sorted * disc, zero).sum(dim=1)
    max_dcg = torch.clamp_min(max_dcg, 1e-12)

    idx_o = torch.argsort(-o_key, dim=1, stable=True)   # model-desc order
    gain_o = torch.exp2(torch.gather(s, 1, idx_o)) - 1.0
    dcg = torch.where(topk, gain_o * disc, zero).sum(dim=1)
    ndcg = dcg / max_dcg

    sort_size = n if max_sort_size < 0 else torch.clamp_max(n, max_sort_size)
    i, j = pos[None, :, None], pos[None, None, :]
    pair = (i < j) & (j < n[:, None, None]) & (i < sort_size[:, None, None])
    g2 = torch.exp2(s_sorted)
    diff2 = g2[:, :, None] - g2[:, None, :]
    dcg_dif = torch.where(j < sort_size[:, None, None],
                          diff2 * (disc[:, None] - disc[None, :]),
                          diff2 * disc[:, None])
    lam = -dcg_dif.abs() / (1.0 + torch.exp(o_sorted[:, :, None]
                                            - o_sorted[:, None, :]))
    lam = torch.where(pair, lam, torch.zeros_like(lam)) \
        / max_dcg[:, None, None]
    g_sorted = lam.sum(dim=2) - lam.sum(dim=1)
    grad = torch.zeros_like(o).scatter(1, idx_l, g_sorted)
    return ndcg, grad


class _LambdaRank(torch.autograd.Function):
    """NDCG forward whose backward is the lambda gradient (the JAX op's
    ``jax.custom_vjp``), not the NDCG's own."""

    @staticmethod
    def forward(ctx, o, s, n, k, max_sort_size):
        ndcg, grad = _lambda_rank_groups(o, s, n, k, max_sort_size)
        ctx.save_for_backward(grad)
        return ndcg

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        return grad * g[:, None], None, None, None, None


@register_op("lambda_rank")
def _lambda_rank(ctx, ins, attrs):
    """Listwise LambdaRank over padded query groups (``loss_ops.py:
    187-226``).  Score [B, M] (or [B, M, 1]), Label [B, M(, 1)], the
    valid counts from Score's ``@LEN`` (all M without one).  Out: NDCG@k
    a group, [B, 1] fp32, whose gradient is the lambda direction."""
    from .sequence_ops import _seq_lens_or_full

    o = ins["Score"][0]
    s = ins["Label"][0]
    if o.dim() == 3:
        o = o[:, :, 0]
    if s.dim() == 3:
        s = s[:, :, 0]
    s = s.detach().to(torch.float32)
    lens = _seq_lens_or_full(ctx, o, slot="Score").detach()
    k = int(attrs.get("ndcg_num", 5))
    mss = int(attrs.get("max_sort_size", -1))
    ndcg = _LambdaRank.apply(o.to(torch.float32), s, lens, k, mss)
    return {"Out": ndcg[:, None]}


@register_op("cross_entropy_over_beam")
def _cross_entropy_over_beam(ctx, ins, attrs):
    """Beam-level training cost (``loss_ops.py:229-259``): at each
    expansion step (scores [B, K], candidate ids [B, K], gold id [B]) the
    cross entropy of the gold candidate among the beam's, summed over the
    steps.  A gold that fell off the beam is a (K + 1)-th path scored
    min(scores) - 4, as in the JAX op."""
    total = None
    for s, c, g in zip(ins["Scores"], ins["Cands"], ins["Gold"]):
        s = s.reshape(s.shape[0], -1).to(torch.float32)
        c = c.reshape(c.shape[0], -1)
        g = g.reshape(-1).to(c.dtype)
        K = s.shape[1]
        match = c == g[:, None]
        in_beam = match.any(dim=1)
        pos = torch.argmax(match.to(torch.int32), dim=1)
        extra = torch.where(in_beam, torch.full_like(s[:, 0], -1e30),
                            torch.amin(s, dim=1) - 4.0)
        logp = torch.log_softmax(torch.cat([s, extra[:, None]], dim=1), dim=1)
        idx = torch.where(in_beam, pos, torch.full_like(pos, K))
        ce = -torch.gather(logp, 1, idx[:, None].to(torch.int64))[:, 0]
        total = ce if total is None else total + ce
    return {"Out": total[:, None]}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo, dim_ok,  # noqa: E402
                                    first, same_as, shapes_compatible)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn("hinge_loss")(same_as("Logits", out="Loss"))
register_shape_fn("log_loss")(same_as("Predicted", out="Loss"))
register_shape_fn("sigmoid_cross_entropy_with_logits")(same_as("X"))
register_shape_fn("mse_loss")(same_as("X"))
register_shape_fn("kldiv_loss")(same_as("X", out="Loss"))
register_shape_fn("rank_loss")(same_as("Left"))
register_shape_fn("huber_loss")(same_as("X", also=("Residual",)))
register_shape_fn("modified_huber_loss")(
    same_as("X", also=("IntermediateVal",)))
register_shape_fn("margin_rank_loss")(same_as("X1", also=("Activated",)))


def _rowwise(x, extra=1):
    b = x.shape[0] if x.shape is not None else -1
    return VarInfo((b, extra), x.dtype)


@register_shape_fn("smooth_l1_loss")
def _smooth_l1_shape(op, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if not shapes_compatible(x.shape, y.shape):
        raise ShapeError(
            f"smooth_l1_loss: X {list(x.shape)} vs Y {list(y.shape)}")
    return {"Out": _rowwise(x), "Diff": x}


@register_shape_fn("squared_l2_distance")
def _squared_l2_distance_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": _rowwise(x), "sub_result": x}


@register_shape_fn("cos_sim")
def _cos_sim_shape(op, ins, attrs):
    x = first(ins, "X")
    n = _rowwise(x)
    return {"Out": n, "XNorm": n, "YNorm": n}


@register_shape_fn("bilinear_tensor_product")
def _bilinear_tp_shape(op, ins, attrs):
    x, w = first(ins, "X"), first(ins, "Weight")
    if x.shape is None or w.shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    if x.shape[-1] >= 0 and w.shape[1] >= 0 and \
            not dim_ok(x.shape[-1], w.shape[1]):
        raise ShapeError(
            f"bilinear_tensor_product: X dim {x.shape[-1]} vs Weight dx "
            f"{w.shape[1]}")
    return {"Out": VarInfo((x.shape[0], w.shape[0]), x.dtype)}


@register_shape_fn("lambda_rank")
def _lambda_rank_shape(op, ins, attrs):
    return {"Out": _rowwise(first(ins, "Score"))}


@register_shape_fn("cross_entropy_over_beam")
def _ce_over_beam_shape(op, ins, attrs):
    return {"Out": _rowwise(first(ins, "Scores"))}


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop): loss heads keep the
# batch sharding; elementwise losses are shape-preserving.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (shard_batch_only,  # noqa: E402
                                   shard_same_as)
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("hinge_loss")(shard_same_as("Logits", out="Loss"))
register_shard_fn("log_loss")(shard_same_as("Predicted", out="Loss"))
register_shard_fn("sigmoid_cross_entropy_with_logits", "mse_loss")(
    shard_same_as("X"))
register_shard_fn("kldiv_loss")(shard_same_as("X", out="Loss"))
register_shard_fn("rank_loss")(shard_same_as("Left"))
register_shard_fn("huber_loss")(shard_same_as("X", also=("Residual",)))
register_shard_fn("margin_rank_loss")(
    shard_same_as("X1", also=("Activated",)))
register_shard_fn("smooth_l1_loss")(shard_batch_only("X"))
register_shard_fn("squared_l2_distance")(shard_batch_only("X"))
register_shard_fn("cos_sim")(shard_batch_only("X"))
