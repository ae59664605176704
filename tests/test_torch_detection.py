"""The detection family in the port against the JAX package: the 7 op
names of ``paddle_tpu/ops/detection_ops.py`` (``roi_pool``,
``prior_box``, ``box_coder``, ``iou_similarity``, ``ssd_loss``,
``multiclass_nms``, ``detection_output``), the layers ``prior_box``,
``box_coder``, ``iou_similarity``, ``ssd_loss``, ``detection_output`` and
``roi_pool``, and ``evaluator.DetectionMAP`` on the port's output.

* **Single ops** (``op_cases.DET_CASES``): fp32 with the gradients
  against ``jax.vjp``, then bf16.  ``roi_pool`` runs on ReLU features
  whose bins tie at their max (its gradient splits evenly among ties in
  both packages, its Argmax is the lowest flat index), an empty ROI and
  one outside the map; the NMS cases hold tied scores, suppressing
  overlaps and ``keep_top_k`` above the candidates (-1 pad rows).
* **A small SSD program** (``testing/cf_programs.build_ssd_head``, three
  maps, padded ground truth): two Momentum steps through ``ssd_loss``,
  then ``box_coder``, ``detection_output`` and ``DetectionMAP``.

Tolerances: single ops fp32 ``rtol=1e-4, atol=1e-5``, bf16 within 2^-7
of the output's scale, index outputs exactly; the program's losses,
encodings and parameters within ``rtol=1e-5, atol=1e-6``; the detection
rows' labels exactly and boxes and scores within ``rtol=1e-5,
atol=1e-6``; mAP equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu_torch.testing import cf_programs as cf
from paddle_tpu_torch.testing import op_cases as oc

PROG_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = sorted(oc.DET_CASES)


def test_every_detection_name_has_a_case():
    import paddle_tpu.ops.detection_ops as jdet
    import inspect
    from paddle_tpu.core import registry as jreg
    names = {n for n in jreg.registered_ops()
             if inspect.getmodule(jreg.get_op_impl(n)) is jdet}
    assert names == {n.split("[")[0] for n in CASES}
    assert len(names) == 7


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax(name):
    op, ins, attrs, wrt, lens = oc.DET_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "float32", wrt, lens=lens)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax_in_bf16(name):
    op, ins, attrs, _, lens = oc.DET_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "bfloat16", lens=lens)


def test_roi_pool_splits_a_tied_bins_gradient_evenly():
    """One 2 x 2 map of zeros pooled to one bin: every pixel ties at the
    max, so each gets a quarter of the cotangent and Argmax is 0, the
    lowest flat index, in both packages (the cases of ``DET_CASES`` tie
    in many bins of ReLU features, checked against ``jax.vjp``)."""
    ins = {"X": [np.zeros((1, 1, 2, 2), np.float32)],
           "ROIs": [np.float32([[0, 0, 0, 1, 1]])]}
    attrs = {"pooled_height": 1, "pooled_width": 1, "spatial_scale": 1.0}
    j, t, jg, tg = tp.run_op("roi_pool", ins, attrs, "float32", [("X", 0)])
    cot = np.random.RandomState(sum(map(ord, "roi_poolcot")) % 1000) \
        .randn(1, 1, 1, 1)[0, 0, 0, 0]
    np.testing.assert_allclose(tg[0], np.full((1, 1, 2, 2), cot / 4),
                               rtol=1e-6)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-6)
    assert t[("Argmax", 0)].item() == np.asarray(j[("Argmax", 0)]).item() \
        == 0


@pytest.mark.parametrize("name", ["roi_pool", "roi_pool[scale]"])
def test_roi_pool_argmax_points_at_the_bins_max(name):
    """Each Argmax names a pixel of the ROI's image holding its bin's
    value; an empty bin (an ROI outside the map) is 0 with Argmax -1."""
    op, ins, attrs, _, _ = oc.DET_CASES[name](oc.rng(name))
    _, t, _, _ = tp.run_op(op, ins, attrs)
    out, amax = t[("Out", 0)].numpy(), t[("Argmax", 0)].numpy()
    x, rois = ins["X"][0], ins["ROIs"][0]
    W = x.shape[3]
    empty = amax < 0
    assert empty.any() and (out[empty] == 0).all()
    for r, c, i, k in zip(*np.nonzero(~empty)):
        h, w = divmod(int(amax[r, c, i, k]), W)
        assert x[int(rois[r, 0]), c, h, w] == out[r, c, i, k]


@pytest.mark.parametrize("name", ["multiclass_nms", "detection_output"])
def test_nms_keeps_tied_scores_in_the_references_order(name):
    """The cases' outputs hold two kept rows of one image with the same
    label and score (their order is ``lax.top_k``'s: the lower candidate
    first), and every unfilled row's label and score are -1 (a
    suppressed candidate's row keeps its box, as in the JAX package);
    the rows equal the JAX package's."""
    op, ins, attrs, _, _ = oc.DET_CASES[name](oc.rng(name))
    j, t, _, _ = tp.run_op(op, ins, attrs)
    rows = t[("Out", 0)].numpy()
    np.testing.assert_allclose(rows, np.asarray(j[("Out", 0)]), **tp.OP_TOL)
    tied = 0
    for b in range(rows.shape[0]):
        pairs = [tuple(r[:2]) for r in rows[b] if r[0] >= 0]
        tied += len(pairs) - len(set(pairs))
    assert tied
    pad = rows[..., 0] < 0
    assert (rows[pad][:, :2] == -1).all()
    if name == "multiclass_nms":
        assert pad.any()


MAPS = ((4, 3, 8.0, 16.0, (2.0,)), (2, 5, 16.0, 24.0, (2.0, 3.0)),
        (1, 4, 24.0, 30.0, (2.0,)))


def test_small_ssd_trains_decodes_and_scores_as_the_reference():
    """SSD's multibox head over three small fed maps in both packages
    from the JAX weights: 2 Momentum steps (losses, encodings, every
    parameter), then the decode (softmax, box_coder, detection_output)
    from the trained weights, and DetectionMAP over its rows."""
    N, M, K, img = 3, 4, 5, 32
    r = np.random.RandomState(0)
    gtb, gtl = cf.ssd_ground_truth(r, N, M, K)
    feed = {"image": np.zeros((1, 3, img, img), np.float32), "gtb": gtb,
            "gtl": gtl}
    for i, (s, ch, *_) in enumerate(MAPS):
        feed[f"map{i}"] = np.maximum(r.randn(N, ch, s, s), 0).astype(
            np.float32)
    m = tp.both_built(lambda pkg: cf.build_ssd_head(pkg, MAPS, K, M, img,
                                                    lr=0.1))
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    (jm, jv, js), (tm, tv, ts) = m["jax"], m["torch"]
    for _ in range(2):
        jo = jexe.run(jm, feed=feed, fetch_list=[jv["loss"], jv["loc"]],
                      scope=js)
        to = texe.run(tm, feed=feed, fetch_list=[tv["loss"], tv["loc"]],
                      scope=ts)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a, np.asarray(b), **PROG_TOL)
    assert np.asarray(to[1]).shape == (N, 16 * 4 + 4 * 6 + 1 * 4, 4)
    for k in js.keys():
        np.testing.assert_allclose(ts.numpy(k), js.numpy(k), err_msg=k,
                                   **PROG_TOL)
    nms = dict(nms_top_k=10, keep_top_k=12, nms_threshold=0.45,
               score_threshold=0.01)
    dets = {}
    for name, pkg, scope in (("jax", pt, js), ("torch", ptt, ts)):
        main, _, v = cf.build_ssd_head(pkg, MAPS, K, M, img, batch=N,
                                       decode=True, nms=nms)
        dfeed = {k: a for k, a in feed.items() if k not in ("gtb", "gtl")}
        exe = pkg.Executor(pkg.CPUPlace())
        det, boxes = exe.run(main, feed=dfeed,
                             fetch_list=[v["det"], v["boxes"]], scope=scope)
        ev = pkg.evaluator.DetectionMAP()
        ev.update(np.asarray(det), gtb, gtl)
        dets[name] = (np.asarray(det), np.asarray(boxes), ev.eval())
    (det, boxes, m_ap), (jdet, jboxes, jm_ap) = dets["torch"], dets["jax"]
    assert det.shape == (N, 12, 6)
    np.testing.assert_array_equal(det[..., 0], jdet[..., 0])
    np.testing.assert_allclose(det, jdet, **PROG_TOL)
    np.testing.assert_allclose(boxes, jboxes, **PROG_TOL)
    assert m_ap == jm_ap and 0.0 <= m_ap <= 1.0


def test_prior_box_step_is_image_over_feature():
    """SSD300's first map (38 x 38 over 300 x 300): the cell step is
    300 / 38 (not Caffe's 8), in both packages (ROADMAP Queue C)."""
    ins = {"Input": [np.zeros((1, 1, 38, 38), np.float32)],
           "Image": [np.zeros((1, 3, 300, 300), np.float32)]}
    attrs = {"min_sizes": [30.0], "max_sizes": [], "aspect_ratios": [1.0],
             "flip": False, "clip": False}
    j, t, _, _ = tp.run_op("prior_box", ins, attrs)
    boxes = t[("Boxes", 0)].numpy()
    np.testing.assert_allclose(boxes, np.asarray(j[("Boxes", 0)]),
                               **tp.OP_TOL)
    cx = (boxes[0, 1, 0, 0] + boxes[0, 1, 0, 2]) / 2
    assert abs(cx * 300 - 1.5 * 300 / 38) < 1e-3
