"""Detection layers (counterpart of ``paddle_tpu/layers/detection.py``: v1
PriorBox, MultiBoxLoss and DetectionOutput; ``roi_pool`` is in
``layers/nn.py``)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["prior_box", "box_coder", "iou_similarity", "ssd_loss",
           "detection_output"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=True, clip=True, name=None):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="prior_box",
                     inputs={"Input": [input], "Image": [image]},
                     outputs={"Boxes": [boxes], "Variances": [variances]},
                     attrs={"min_sizes": list(min_sizes),
                            "max_sizes": list(max_sizes or []),
                            "aspect_ratios": list(aspect_ratios or [1.0]),
                            "variances": list(variance or
                                              [0.1, 0.1, 0.2, 0.2]),
                            "flip": flip, "clip": clip})
    return boxes, variances


def box_coder(prior_box, prior_box_var, target_box,
              code_type="decode_center_size", name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    helper.append_op(type="box_coder",
                     inputs={"PriorBox": [prior_box],
                             "PriorBoxVar": [prior_box_var],
                             "TargetBox": [target_box]},
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type})
    return out


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, overlap_threshold=0.5, neg_pos_ratio=3.0,
             loc_loss_weight=1.0, conf_loss_weight=1.0, background_label=0,
             name=None):
    """SSD MultiBox loss (MultiBoxLoss.cpp; fluid layers/detection.py
    ssd_loss): matching + smooth-L1 localization + hard-negative-mined
    softmax confidence, fused in one op.  Ground truth is PADDED
    [N, M, ...] with gt_label < 0 on padding rows (static shapes, no
    LoD).  Returns the per-image loss [N, 1]."""
    helper = LayerHelper("ssd_loss", name=name)
    out = helper.create_variable_for_type_inference(
        location.dtype, (location.shape[0], 1))
    ins = {"Location": [location], "Confidence": [confidence],
           "GTBox": [gt_box], "GTLabel": [gt_label],
           "PriorBox": [prior_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="ssd_loss", inputs=ins,
                     outputs={"Loss": [out]},
                     attrs={"overlap_threshold": overlap_threshold,
                            "neg_pos_ratio": neg_pos_ratio,
                            "loc_loss_weight": loc_loss_weight,
                            "conf_loss_weight": conf_loss_weight,
                            "background_label": background_label})
    return out


def detection_output(scores, bboxes, score_threshold=0.01,
                     nms_threshold=0.45, nms_top_k=64, keep_top_k=16,
                     background_label=0, name=None):
    """Decode-and-NMS head (detection_output_op): Scores [N,P,C]
    post-softmax, BBoxes [N,P,4] decoded corner boxes -> [N, keep_top_k, 6]
    rows (label, score, x1, y1, x2, y2), -1-padded."""
    helper = LayerHelper("detection_output", name=name)
    out = helper.create_variable_for_type_inference(
        bboxes.dtype, (scores.shape[0], keep_top_k, 6))
    helper.append_op(type="multiclass_nms",
                     inputs={"Scores": [scores], "BBoxes": [bboxes]},
                     outputs={"Out": [out]},
                     attrs={"score_threshold": score_threshold,
                            "nms_threshold": nms_threshold,
                            "nms_top_k": nms_top_k,
                            "keep_top_k": keep_top_k,
                            "background_label": background_label})
    return out
