"""Detection ops (counterpart of ``paddle_tpu/ops/detection_ops.py``:
``roi_pool``, ``prior_box``, ``box_coder``, ``iou_similarity``,
``ssd_loss``, ``multiclass_nms`` / ``detection_output``).

The JAX lowerings are static-shaped TPU redesigns of the reference's
ragged LoD outputs: padded ground truth with label -1 on pad rows, a
fixed ``[N, keep_top_k, 6]`` NMS slab padded with -1.  The port keeps
those shapes and batches what the JAX package ``vmap``s: ROIs, images
and classes are tensor dims, never a Python loop, so a CUDA graph holds
every op here.

* ``roi_pool`` scatter-maxes each ROI's pixels into its ``[ph, pw]``
  bins (``scatter_reduce("amax")``, whose gradient splits evenly among
  tied maxima, as ``.at[].max``'s does) and takes ``Argmax`` as the
  scatter-min of the flat index among the pixels that reach their bin's
  max.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
* ``ssd_loss``'s hard-negative mining ranks by a stable descending sort,
  as ``jnp.argsort(-x)`` does.
* The NMS ranks candidates with ``generation_ops.top_k`` (``lax.top_k``'s
  order: among equal scores the lower index first), which decides which
  boxes and padded rows come out; its greedy pass is a loop of ``k``
  steps over ``[N, C-1, k]`` tensors, fixed at build time.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .generation_ops import top_k
from .tensor_ops import _constant


def _top_k(x, k):
    """``lax.top_k`` of the rows of ``x`` (any float dtype): the order is
    decided on the float32 values, which keep a bf16 row's order."""
    _, idx = top_k(x.float(), k)
    return torch.gather(x, -1, idx), idx


@register_op("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """X [N, C, H, W]; ROIs [R, 5] = (batch index, x1, y1, x2, y2) in the
    input's scale.  Out [R, C, ph, pw] (0 in an empty bin), Argmax the
    flat h * W + w index of each bin's max (-1 in an empty bin)."""
    x, rois = ins["X"][0], ins["ROIs"][0].float()
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    scale = attrs.get("spatial_scale", 1.0)
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in range(1, 5))
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    hs = torch.arange(H, dtype=torch.float32, device=dev)
    ws = torch.arange(W, dtype=torch.float32, device=dev)
    # each pixel's bin (clipped), and whether it lies inside the ROI
    bin_h = torch.floor((hs[None] - y1[:, None]) / (rh / ph)[:, None])
    bin_w = torch.floor((ws[None] - x1[:, None]) / (rw / pw)[:, None])
    valid = (((hs[None] >= y1[:, None]) & (hs[None] <= y2[:, None]))
             [:, None, :, None]
             & ((ws[None] >= x1[:, None]) & (ws[None] <= x2[:, None]))
             [:, None, None, :])                          # [R, 1, H, W]
    oh = bin_h.clamp(0, ph - 1).long()
    ow = bin_w.clamp(0, pw - 1).long()
    bins = (oh[:, :, None] * pw + ow[:, None, :]).reshape(R, 1, H * W)
    bins = bins.expand(R, C, H * W)
    neg = torch.full((), -3.4e38, dtype=x.dtype, device=dev)
    img = x[b]                                            # [R, C, H, W]
    masked = torch.where(valid, img, neg).reshape(R, C, H * W)
    out = neg.expand(R, C, ph * pw).scatter_reduce(
        2, bins, masked, "amax", include_self=True)
    # Argmax: a pixel is its bin's argmax iff it reaches the bin's max;
    # among ties the smallest flat index (scatter-min)
    at_max = valid.reshape(R, 1, H * W) & (
        img.reshape(R, C, H * W) == out.detach().gather(2, bins))
    flat = torch.arange(H * W, dtype=torch.int32, device=dev)
    cand = torch.where(at_max, flat, H * W)
    amax = torch.full((R, C, ph * pw), H * W, dtype=torch.int32,
                      device=dev).scatter_reduce(2, bins, cand, "amin")
    empty = out <= neg / 2
    out = torch.where(empty, torch.zeros((), dtype=x.dtype, device=dev), out)
    amax = torch.where(empty | (amax >= H * W), -1, amax).long()
    return {"Out": out.reshape(R, C, ph, pw),
            "Argmax": amax.reshape(R, C, ph, pw)}


def _prior_boxes(min_sizes, max_sizes, ars, flip):
    """The (width, height) of each prior a cell, in the JAX lowering's
    order: per min size, the square, the sqrt(min * max) squares, then
    each aspect ratio (and its flip) but 1."""
    full_ars = []
    for ar in ars:
        full_ars.append(ar)
        if flip and ar != 1.0:
            full_ars.append(1.0 / ar)
    boxes = []
    for ms in min_sizes:
        boxes.append((ms, ms))
        for mx in max_sizes:
            s = (ms * mx) ** 0.5
            boxes.append((s, s))
        for ar in full_ars:
            if ar == 1.0:
                continue
            boxes.append((ms * ar ** 0.5, ms / ar ** 0.5))
    return boxes


@register_op("prior_box")
def _prior_box(ctx, ins, attrs):
    """SSD priors of a feature map: Boxes [fh, fw, nb, 4] corner form in
    [0, 1], Variances broadcast to it.  A cell's step is image / feature
    size (300 / 38 on SSD300's first map, not Caffe's 8: ROADMAP Queue
    C)."""
    feat, img = ins["Input"][0], ins["Image"][0]
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    dev = feat.device
    step_h, step_w = ih / fh, iw / fw
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + 0.5) * step_h
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5) * step_w
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    boxes = _prior_boxes(attrs["min_sizes"], attrs.get("max_sizes", []),
                         attrs.get("aspect_ratios", [1.0]),
                         attrs.get("flip", True))
    prior = torch.stack([torch.stack(
        [(cxg - bw / 2) / iw, (cyg - bh / 2) / ih,
         (cxg + bw / 2) / iw, (cyg + bh / 2) / ih], dim=-1)
        for bw, bh in boxes], dim=2)
    if attrs.get("clip", True):
        prior = prior.clamp(0.0, 1.0)
    var = _constant(ctx, list(variances), torch.float32, dev)
    return {"Boxes": prior, "Variances": var.expand(prior.shape)}


def _center(box):
    """(width, height, center x, center y) of corner-form boxes [..., 4]."""
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return w, h, (box[..., 0] + box[..., 2]) / 2, \
        (box[..., 1] + box[..., 3]) / 2


@register_op("box_coder")
def _box_coder(ctx, ins, attrs):
    """decode_center_size: TargetBox's encodings against the priors (and
    their variances) to corner-form boxes of TargetBox's shape."""
    prior = ins["PriorBox"][0].reshape(-1, 4)
    pvar = ins["PriorBoxVar"][0].reshape(-1, 4) if ins.get("PriorBoxVar") \
        else torch.ones_like(prior)
    target = ins["TargetBox"][0]
    pw, ph, pcx, pcy = _center(prior)
    t = target.reshape(-1, 4)
    cx = pvar[:, 0] * t[:, 0] * pw + pcx
    cy = pvar[:, 1] * t[:, 1] * ph + pcy
    w = torch.exp(pvar[:, 2] * t[:, 2]) * pw
    h = torch.exp(pvar[:, 3] * t[:, 3]) * ph
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    return {"OutputBox": out.reshape(target.shape)}


def _iou(a, b):
    """IoU of corner-form boxes a [..., A, 4] against b [..., B, 4]:
    [..., A, B]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-10)


@register_op("iou_similarity")
def _iou_similarity(ctx, ins, attrs):
    return {"Out": _iou(ins["X"][0].reshape(-1, 4),
                        ins["Y"][0].reshape(-1, 4))}


@register_op("ssd_loss")
def _ssd_loss(ctx, ins, attrs):
    """MultiBoxLoss: each prior matched to its best ground truth, each
    ground truth forcing its own best prior (a bipartite pass by
    scatter-max, so a pad row cannot overwrite a real one's claim);
    smooth-L1 on the positives' encodings; softmax cross-entropy; the
    negatives with the highest loss, ``neg_pos_ratio`` to each positive
    (a stable descending sort).

    Location [N, P, 4], Confidence [N, P, C] logits, GTBox [N, M, 4]
    corner form, GTLabel [N, M] (or [N, M, 1]; < 0 on pad rows),
    PriorBox [P, 4], PriorBoxVar [P, 4] (default 0.1, 0.1, 0.2, 0.2).
    Loss [N, 1]: (loc + conf) / max(positives, 1)."""
    loc = ins["Location"][0]
    conf = ins["Confidence"][0]
    gt_box = ins["GTBox"][0]
    gt_label = ins["GTLabel"][0].int()
    if gt_label.dim() == 3:
        gt_label = gt_label.squeeze(-1)
    prior = ins["PriorBox"][0].reshape(-1, 4)
    pvar = ins["PriorBoxVar"][0].reshape(-1, 4) if ins.get("PriorBoxVar") \
        else _constant(ctx, [0.1, 0.1, 0.2, 0.2], loc.dtype,
                       loc.device).expand(prior.shape)
    overlap_t = attrs.get("overlap_threshold", 0.5)
    neg_ratio = attrs.get("neg_pos_ratio", 3.0)
    loc_w = attrs.get("loc_loss_weight", 1.0)
    conf_w = attrs.get("conf_loss_weight", 1.0)
    background = int(attrs.get("background_label", 0))
    N, P, C = conf.shape
    M = gt_box.shape[1]
    dev = loc.device
    pw, ph, pcx, pcy = _center(prior)

    # IoU [N, M, P], -1 on pad rows
    valid_gt = gt_label >= 0                                   # [N, M]
    iou = torch.where(valid_gt[:, :, None], _iou(gt_box, prior), -1.0)
    best_iou = iou.amax(dim=1)                                 # [N, P]
    # argmax: the first of equal maxima, as jnp.argmax
    best_gt = torch.argmax(iou, dim=1)
    best_prior = torch.argmax(iou, dim=2)                      # [N, M]
    forced = torch.zeros((N, P), dtype=torch.int32, device=dev) \
        .scatter_reduce(1, best_prior, valid_gt.int(), "amax") > 0
    m_idx = torch.arange(M, dtype=torch.int32, device=dev).expand(N, M)
    forced_gt = torch.full((N, P), -1, dtype=torch.int32, device=dev) \
        .scatter_reduce(1, best_prior, torch.where(valid_gt, m_idx, -1),
                        "amax")
    pos = forced | (best_iou >= overlap_t)
    match = torch.where(forced_gt >= 0, forced_gt, best_gt.int()).long()
    num_pos = pos.sum(dim=1)                                   # [N]

    # localization: smooth-L1 against the matched ground truth's encoding
    gw = torch.clamp(gt_box[..., 2] - gt_box[..., 0], min=1e-10)
    gh = torch.clamp(gt_box[..., 3] - gt_box[..., 1], min=1e-10)
    gcx = (gt_box[..., 0] + gt_box[..., 2]) / 2
    gcy = (gt_box[..., 1] + gt_box[..., 3]) / 2
    targets = torch.stack([
        (gcx[..., None] - pcx) / pw / pvar[:, 0],
        (gcy[..., None] - pcy) / ph / pvar[:, 1],
        torch.log(gw[..., None] / pw) / pvar[:, 2],
        torch.log(gh[..., None] / ph) / pvar[:, 3]], dim=-1)  # [N, M, P, 4]
    tgt = targets.gather(1, match[:, None, :, None].expand(N, 1, P, 4))[:, 0]
    d = loc - tgt
    ad = d.abs()
    smooth = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    loc_loss = torch.where(pos[..., None], smooth, 0.0).sum(dim=(1, 2))

    # confidence: softmax cross-entropy against the matched label
    tgt_cls = torch.where(pos, gt_label.gather(1, match), background)
    ce = -torch.log_softmax(conf, dim=-1).gather(
        2, tgt_cls.long()[..., None])[..., 0]                  # [N, P]
    # hard negatives: the (neg_ratio * positives) highest losses
    neg_ce = torch.where(pos, float("-inf"), ce.detach())
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=dev).expand(N, P))
    num_neg = torch.minimum((neg_ratio * num_pos).int(), P - num_pos)
    neg = ~pos & (rank < num_neg[:, None])
    conf_loss = torch.where(pos | neg, ce, 0.0).sum(dim=1)

    denom = torch.clamp(num_pos.to(loc.dtype), min=1.0)
    return {"Loss": ((loc_w * loc_loss + conf_w * conf_loss) / denom)[:, None]}


@register_op("multiclass_nms", "detection_output")
def _detection_output(ctx, ins, attrs):
    """Per-class greedy NMS and the top ``keep_top_k`` over classes.

    Scores [N, P, C] (after softmax), BBoxes [N, P, 4] decoded corner
    boxes.  Each class but the background keeps its ``nms_top_k`` best
    boxes, suppresses those overlapping a kept better box by more than
    ``nms_threshold``, and the best ``keep_top_k`` of all classes come out
    as rows (label, score, x1, y1, x2, y2): Out [N, keep_top_k, 6], -1
    where a slot holds no box above ``score_threshold``."""
    scores, boxes = ins["Scores"][0], ins["BBoxes"][0]
    score_thresh = attrs.get("score_threshold", 0.01)
    nms_thresh = attrs.get("nms_threshold", 0.45)
    nms_top_k = int(attrs.get("nms_top_k", 64))
    keep_top_k = int(attrs.get("keep_top_k", 16))
    background = int(attrs.get("background_label", 0))
    N, P, C = scores.shape
    dev = scores.device
    # the classes but the background, made on the device (no host list
    # to copy inside a capture)
    cls = torch.arange(C, device=dev)
    if 0 <= background < C:
        cls = cls[:C - 1] + (cls[:C - 1] >= background).long()
    G = cls.shape[0]
    k = min(nms_top_k, P)
    s = scores.index_select(2, cls).transpose(1, 2)            # [N, G, P]
    top_s, top_i = _top_k(s, k)                                # [N, G, k]
    cand = boxes.gather(1, top_i.reshape(N, G * k, 1).expand(
        N, G * k, 4)).reshape(N, G, k, 4)
    keep = top_s > score_thresh

    def area(v):
        return torch.clamp(v[..., 2] - v[..., 0], min=0) * \
            torch.clamp(v[..., 3] - v[..., 1], min=0)

    a_cand = area(cand)
    later = torch.arange(k, device=dev)
    for i in range(k):
        ref = cand[:, :, i:i + 1]                              # [N, G, 1, 4]
        inter = torch.clamp(torch.minimum(cand[..., 2], ref[..., 2])
                            - torch.maximum(cand[..., 0], ref[..., 0]),
                            min=0) * \
            torch.clamp(torch.minimum(cand[..., 3], ref[..., 3])
                        - torch.maximum(cand[..., 1], ref[..., 1]), min=0)
        iou = inter / torch.clamp(a_cand + a_cand[:, :, i:i + 1] - inter,
                                  min=1e-10)
        keep = keep & ~((iou > nms_thresh) & (later > i)
                        & keep[:, :, i:i + 1])
    cs = torch.where(keep, top_s * keep, -1.0).reshape(N, G * k)
    cb = cand.reshape(N, G * k, 4)
    cl = cls.to(torch.float32).repeat_interleave(k)
    k2 = min(keep_top_k, G * k)
    fs, fi = _top_k(cs, k2)
    lab = torch.where(fs > score_thresh, cl[fi], -1.0)
    row = torch.cat([lab[..., None], fs[..., None],
                     cb.gather(1, fi[..., None].expand(N, k2, 4))], dim=2)
    if k2 < keep_top_k:
        row = torch.cat([row, torch.full((N, keep_top_k - k2, 6), -1.0,
                                         dtype=row.dtype, device=dev)], 1)
    return {"Out": row}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (the JAX package's exact rules: these static
# lowerings need no allowlist entry) and shard rules (detection heads keep
# the image or ROI batch sharding; priors replicate).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import ShapeError, VarInfo, first  # noqa: E402
from ..analysis.shard_prop import (shard_batch_only,  # noqa: E402
                                   shard_replicated)
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)


@register_shape_fn("iou_similarity")
def _iou_similarity_shape(op, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    for name, v in (("X", x), ("Y", y)):
        if v.shape is not None and len(v.shape) >= 1 and \
                v.shape[-1] >= 0 and v.shape[-1] != 4:
            raise ShapeError(
                f"iou_similarity: {name} boxes must be [*, 4], got "
                f"{list(v.shape)}")
    n = x.shape[0] if x.shape is not None else -1
    m = y.shape[0] if y.shape is not None else -1
    return {"Out": VarInfo((n, m), x.dtype)}


@register_shape_fn("roi_pool")
def _roi_pool_shape(op, ins, attrs):
    x, rois = first(ins, "X"), first(ins, "ROIs")
    if rois.shape is not None and len(rois.shape) == 2 and \
            rois.shape[-1] >= 0 and rois.shape[-1] != 5:
        raise ShapeError(
            f"roi_pool: ROIs must be [R, 5] (batch_idx, x1, y1, x2, y2), "
            f"got {list(rois.shape)}")
    r = rois.shape[0] if rois.shape is not None else -1
    c = x.shape[1] if x.shape is not None and len(x.shape) == 4 else -1
    shape = (r, c, int(attrs["pooled_height"]), int(attrs["pooled_width"]))
    return {"Out": VarInfo(shape, x.dtype),
            "Argmax": VarInfo(shape, "int64")}


@register_shape_fn("prior_box")
def _prior_box_shape(op, ins, attrs):
    feat = first(ins, "Input")
    nb = len(_prior_boxes(attrs["min_sizes"], attrs.get("max_sizes", []),
                          attrs.get("aspect_ratios", [1.0]),
                          attrs.get("flip", True)))
    four = feat.shape is not None and len(feat.shape) == 4
    fh = feat.shape[2] if four else -1
    fw = feat.shape[3] if four else -1
    dt = feat.dtype if feat.dtype is not None else "float32"
    info = VarInfo((fh, fw, nb, 4), dt)
    return {"Boxes": info, "Variances": info}


@register_shape_fn("box_coder")
def _box_coder_shape(op, ins, attrs):
    prior, target = first(ins, "PriorBox"), first(ins, "TargetBox")
    for name, v in (("PriorBox", prior), ("TargetBox", target)):
        if v.shape is not None and len(v.shape) >= 1 and \
                v.shape[-1] >= 0 and v.shape[-1] != 4:
            raise ShapeError(
                f"box_coder: {name} must be [*, 4], got {list(v.shape)}")
    return {"OutputBox": target}


@register_shape_fn("ssd_loss")
def _ssd_loss_shape(op, ins, attrs):
    conf, loc = first(ins, "Confidence"), first(ins, "Location")
    if conf.shape is not None and len(conf.shape) != 3:
        raise ShapeError(
            f"ssd_loss: Confidence must be [N, P, C], got "
            f"{list(conf.shape)}")
    if loc.shape is not None and len(loc.shape) >= 1 and \
            loc.shape[-1] >= 0 and loc.shape[-1] != 4:
        raise ShapeError(
            f"ssd_loss: Location must be [N, P, 4], got "
            f"{list(loc.shape)}")
    n = conf.shape[0] if conf.shape is not None else \
        (loc.shape[0] if loc.shape is not None else -1)
    dt = loc.dtype if loc.dtype is not None else conf.dtype
    return {"Loss": VarInfo((n, 1), dt)}


@register_shape_fn("multiclass_nms", "detection_output")
def _detection_output_shape(op, ins, attrs):
    scores = first(ins, "Scores")
    if scores.shape is not None and len(scores.shape) != 3:
        raise ShapeError(
            f"detection_output: Scores must be [N, num_priors, C], got "
            f"{list(scores.shape)}")
    n = scores.shape[0] if scores.shape is not None else -1
    keep = int(attrs.get("keep_top_k", 16))
    dt = scores.dtype if scores.dtype is not None else "float32"
    return {"Out": VarInfo((n, keep, 6), dt)}


register_shard_fn("prior_box")(shard_replicated("Boxes", "Variances"))
register_shard_fn("iou_similarity", "box_coder")(shard_replicated(
    "Out", "OutputBox"))
register_shard_fn("ssd_loss", "multiclass_nms", "detection_output",
                  "roi_pool")(shard_batch_only(
                      "Location", out="Loss",
                      fallbacks=("Scores", "X"),
                      also=("Out", "Argmax")))
