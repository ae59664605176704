"""The dense op families in the port against their JAX lowerings: every
op name of ``paddle_tpu/ops/activation_ops.py``, ``nn_ops.py``,
``loss_ops.py`` and ``metric_ops.py`` that the port registers, with
``transpose``, ``top_k``, ``argmax`` (``arg_max``, ``max_ids``),
``one_hot`` and the five ``reduce_*``.

One case per op name, run through ``torch_parity.run_op`` (each
package's registered lowering called on the same numpy-seeded inputs): the forward outputs, their dtypes and,
where the op is differentiable, the gradient of sum(output * cotangent)
with respect to the float inputs against ``jax.vjp``.  Every case runs
again in bf16 (the AMP compute dtype) with the output dtypes equal to
JAX's.  ``lambda_rank`` reads its groups' lengths from ``@LEN``, so it
runs as a one-op program through both packages' ``interpret_ops``, and
also against a numpy port of the reference's LambdaCost
(``tests/test_lambda_rank.py``).  Last, the numpy references of the JAX
package's op tests (``tests/test_ops_nn.py``, ``test_ops_math.py``,
``test_ops_misc.py``) on the port's ops, at those tests' tolerances.

Inputs stay away from kinks and ties (``_away``, ``_distinct``) for
``relu6``, ``brelu``, ``hard_shrink``, ``thresholded_relu``, ``abs``,
``round``, ``maxout``, ``spp``, ``max_pool2d_with_index``/``unpool``
and the other piecewise ops; ``top_k`` has a tie-free case and tied
ones (``lax.top_k``'s order among equal values).

Tolerances: fp32 ``rtol=1e-4, atol=1e-5`` (both compute in fp32; only
the order of sums differs); bf16 within 2^-7 of the output's scale (its
largest magnitude), a bf16 rounding or two.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl

TOL = tp.OP_TOL


def _rng(name):
    return np.random.RandomState(sum(map(ord, name)) % 1000)


def _away(x, kinks, gap=0.1):
    """x with every value within ``gap`` of a kink moved ``gap`` off it."""
    x = np.array(x, np.float32)
    for k in kinks:
        near = np.abs(x - k) < gap
        x[near] = k + np.where(x[near] >= k, gap, -gap)
    return x


def _distinct(r, *shape, scale=1.0):
    """Values a shuffle of evenly spaced points in [-scale, scale): no
    ties, even after rounding to bf16, for shapes of up to ~200."""
    n = int(np.prod(shape))
    v = (np.arange(n) - n / 2) * (2.0 * scale / n)
    return r.permutation(v).reshape(shape).astype(np.float32)


_check = tp.check_op


# ---------------------------------------------------------------------------
# The cases: name -> (op, ins, attrs, wrt), inputs from a numpy seed
# ---------------------------------------------------------------------------
X = [("X", 0)]


def _act(op, attrs=None, kinks=(), lo=None, x=None):
    def case(r):
        v = r.randn(3, 5, 7).astype(np.float32) * 2.0 if x is None else x(r)
        if lo is not None:
            v = np.abs(v) + lo
        return op, {"X": [_away(v, kinks)]}, attrs or {}, X
    return case


def _prelu(mode):
    def case(r):
        x = _away(r.randn(2, 3, 4, 5), [0.0])
        alpha = {"all": r.rand(1), "channel": r.rand(3),
                 "element": r.rand(3, 4, 5)}[mode].astype(np.float32)
        return "prelu", {"X": [x], "Alpha": [alpha]}, {"mode": mode}, \
            [("X", 0), ("Alpha", 0)]
    return case


def _conv2d_transpose(r):
    x, w = r.randn(2, 4, 5, 5), r.randn(4, 3, 3, 3) * 0.3
    return "conv2d_transpose", {"Input": [x.astype(np.float32)],
                                "Filter": [w.astype(np.float32)]}, \
        {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}, \
        [("Input", 0), ("Filter", 0)]


def _conv3d(r):
    x, w = r.randn(2, 3, 5, 6, 6), r.randn(4, 3, 3, 3, 3) * 0.2
    return "conv3d", {"Input": [x.astype(np.float32)],
                      "Filter": [w.astype(np.float32)]}, \
        {"strides": [1, 2, 2], "paddings": [1, 1, 1],
         "dilations": [1, 1, 1], "groups": 1}, \
        [("Input", 0), ("Filter", 0)]


def _depthwise(r):
    x, w = r.randn(2, 4, 6, 6), r.randn(4, 1, 3, 3) * 0.3
    return "depthwise_conv2d", {"Input": [x.astype(np.float32)],
                                "Filter": [w.astype(np.float32)]}, \
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 4, "use_pallas": False}, [("Input", 0), ("Filter", 0)]


def _pool3d(ptype):
    def case(r):
        return "pool3d", {"X": [_distinct(r, 2, 2, 4, 5, 6)]}, \
            {"pooling_type": ptype, "ksize": [2, 2, 2],
             "strides": [2, 2, 2], "paddings": [0, 1, 1]}, X
    return case


def _pool_with_index(op):
    def case(r):
        return op, {"X": [_distinct(r, 2, 3, 7, 7)]}, \
            {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, X
    return case


def _unpool(r):
    x = _distinct(r, 2, 3, 6, 6)
    j = jax_impl("max_pool2d_with_index")(
        None, {"X": [jnp.asarray(x)]},
        {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]})
    return "unpool", {"X": [r.randn(2, 3, 3, 3).astype(np.float32)],
                      "Indices": [np.asarray(j["Mask"])]}, \
        {"unpool_size": [6, 6], "ksize": [2, 2]}, X


def _layer_norm(begin):
    def case(r):
        x = r.randn(4, 6, 8).astype(np.float32) * 2 + 0.5
        n = int(np.prod(x.shape[begin:]))
        return "layer_norm", {"X": [x], "Scale": [r.randn(n).astype(
            np.float32)], "Bias": [r.randn(n).astype(np.float32)]}, \
            {"epsilon": 1e-5, "begin_norm_axis": begin}, \
            [("X", 0), ("Scale", 0), ("Bias", 0)]
    return case


def _log_softmax(r):
    return "log_softmax", {"X": [r.randn(3, 4, 10).astype(np.float32)]}, \
        {"axis": 1}, X


def _swce(kind):
    def case(r):
        if kind == "hard":
            logits = r.randn(6, 11).astype(np.float32) * 3
            label = r.randint(0, 11, (6, 1)).astype(np.int64)
        elif kind == "soft":
            logits = r.randn(6, 11).astype(np.float32) * 3
            p = np.exp(r.randn(6, 11))
            label = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        else:                           # a decoder's [B, T, V] logits
            logits = r.randn(2, 5, 13).astype(np.float32) * 3
            label = r.randint(0, 13, (2, 5, 1)).astype(np.int64)
        return "softmax_with_cross_entropy", \
            {"Logits": [logits], "Label": [label]}, \
            {"soft_label": kind == "soft"}, [("Logits", 0)]
    return case


def _maxout(r):
    return "maxout", {"X": [_distinct(r, 2, 6, 3, 3)]}, {"groups": 2}, X


def _bilinear(out_h, out_w):
    def case(r):
        return "bilinear_interp", {"X": [r.randn(2, 3, 5, 7).astype(
            np.float32)]}, {"out_h": out_h, "out_w": out_w}, X
    return case


def _pad_constant_like(r):
    return "pad_constant_like", {"X": [r.randn(3, 5).astype(np.float32)],
                                 "Y": [r.randn(2, 4).astype(np.float32)]}, \
        {"pad_value": 0.5}, [("Y", 0)]


def _spp(ptype):
    def case(r):
        return "spp", {"X": [_distinct(r, 2, 3, 5, 7)]}, \
            {"pyramid_height": 3, "pooling_type": ptype}, X
    return case


def _im2sequence(op):
    def case(r):
        return op, {"X": [r.randn(2, 3, 6, 6).astype(np.float32)]}, \
            {"kernels": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, X
    return case


def _binary(op, x_slot, y_slot, x, y, attrs=None, wrt_y=False):
    def case(r):
        wrt = [(x_slot, 0)] + ([(y_slot, 0)] if wrt_y else [])
        return op, {x_slot: [x(r)], y_slot: [y(r)]}, attrs or {}, wrt
    return case


def _f(*shape, scale=1.0, lo=None, kinks=()):
    def gen(r):
        v = r.randn(*shape).astype(np.float32) * scale
        if lo is not None:
            v = np.abs(v) + lo
        return _away(v, kinks)
    return gen


def _bits(*shape):
    return lambda r: r.randint(0, 2, shape).astype(np.float32)


def _hinge(r):
    logits = r.randn(8, 1).astype(np.float32) * 2
    labels = r.randint(0, 2, (8, 1)).astype(np.float32)
    y = 2 * labels - 1
    # away from y * logit = 1
    logits = np.where(np.abs(y * logits - 1) < 0.1, logits + 0.3 * y, logits)
    return "hinge_loss", {"Logits": [logits.astype(np.float32)],
                          "Labels": [labels]}, {}, [("Logits", 0)]


def _margin_rank(r):
    x1, x2 = r.randn(8, 1).astype(np.float32), r.randn(8, 1).astype(
        np.float32)
    label = np.where(r.rand(8, 1) > 0.5, 1.0, -1.0).astype(np.float32)
    z = -label * (x1 - x2) + 0.1
    x1 = np.where(np.abs(z) < 0.1, x1 - 0.3 * label, x1).astype(np.float32)
    return "margin_rank_loss", {"X1": [x1], "X2": [x2], "Label": [label]}, \
        {"margin": 0.1}, [("X1", 0), ("X2", 0)]


def _rank_loss(r):
    return "rank_loss", {"Label": [_bits(8, 1)(r)],
                         "Left": [r.randn(8, 1).astype(np.float32)],
                         "Right": [r.randn(8, 1).astype(np.float32)]}, {}, \
        [("Left", 0), ("Right", 0)]


def _smooth_l1(r):
    x = r.randn(4, 3, 2).astype(np.float32)
    y = r.randn(4, 3, 2).astype(np.float32)
    iw = (r.rand(4, 3, 2) + 0.5).astype(np.float32)
    d = (x - y) * iw
    # away from |d| = 1 / sigma^2 = 0.25
    x = np.where(np.abs(np.abs(d) - 0.25) < 0.05, x + 0.2, x).astype(
        np.float32)
    return "smooth_l1_loss", {"X": [x], "Y": [y], "InsideWeight": [iw],
                              "OutsideWeight": [(r.rand(4, 3, 2) + 0.5)
                                                .astype(np.float32)]}, \
        {"sigma": 2.0}, [("X", 0), ("Y", 0)]


def _modified_huber(r):
    y = _bits(8, 1)(r)
    x = _away(r.randn(8, 1) * 2, [1.0, -1.0, 0.0])
    return "modified_huber_loss", {"X": [x], "Y": [y]}, {}, X


def _bilinear_tp(r):
    return "bilinear_tensor_product", {
        "X": [r.randn(4, 3).astype(np.float32)],
        "Y": [r.randn(4, 5).astype(np.float32)],
        "Weight": [r.randn(2, 3, 5).astype(np.float32)],
        "Bias": [r.randn(1, 2).astype(np.float32)]}, {}, \
        [("X", 0), ("Y", 0), ("Weight", 0), ("Bias", 0)]


def _ce_over_beam(r):
    B, K = 5, 4
    scores = [r.randn(B, K).astype(np.float32) for _ in range(2)]
    cands = [r.permutation(20)[:B * K].reshape(B, K).astype(np.int64)
             for _ in range(2)]
    gold = []
    for c in cands:
        g = c[np.arange(B), r.randint(0, K, B)].copy()
        g[::2] = 100 + np.arange(len(g[::2]))        # fell off the beam
        gold.append(g.astype(np.int64))
    return "cross_entropy_over_beam", {"Scores": scores, "Cands": cands,
                                       "Gold": gold}, {}, \
        [("Scores", 0), ("Scores", 1)]


def _accuracy(r):
    return "accuracy", {"Out": [r.rand(9, 3).astype(np.float32)],
                        "Indices": [r.randint(0, 5, (9, 3)).astype(np.int64)],
                        "Label": [r.randint(0, 5, (9, 1)).astype(np.int64)]}, \
        {}, ()


def _auc(r):
    p = r.rand(40, 1).astype(np.float32)
    return "auc", {"Predict": [np.concatenate([1 - p, p], 1)],
                   "Label": [r.randint(0, 2, (40, 1)).astype(np.int64)],
                   "StatPos": [r.randint(0, 3, 51).astype(np.float32)],
                   "StatNeg": [r.randint(0, 3, 51).astype(np.float32)]}, \
        {"num_thresholds": 50}, ()


def _precision_recall(r):
    return "precision_recall", {
        "MaxProbs": [r.rand(12, 1).astype(np.float32)],
        "Indices": [r.randint(0, 4, (12, 1)).astype(np.int64)],
        "Labels": [r.randint(0, 4, (12, 1)).astype(np.int64)],
        "StatesInfo": [r.randint(0, 3, (4, 3)).astype(np.float32)]}, \
        {"class_number": 4}, ()


def _pnpair(r):
    return "positive_negative_pair", {
        "Score": [np.round(r.rand(16, 1) * 4).astype(np.float32)],
        "Label": [r.randint(0, 3, (16, 1)).astype(np.float32)],
        "QueryID": [r.randint(0, 3, (16, 1)).astype(np.int64)],
        "AccumulatePositivePair": [np.array([2.0], np.float32)],
        "AccumulateNegativePair": [np.array([1.0], np.float32)],
        "AccumulateNeutralPair": [np.array([3.0], np.float32)]}, {}, ()


def _transpose(r):
    return "transpose", {"X": [r.randn(2, 3, 4).astype(np.float32)]}, \
        {"axis": [2, 0, 1]}, X


def _top_k(r):
    return "top_k", {"X": [_distinct(r, 3, 10)]}, {"k": 4}, X


def _top_k_tied(r):
    """Rows of a few repeated values (exact in bf16 too): lax.top_k puts
    the lower index first among equal values, and so must the port."""
    x = (r.randint(-2, 3, (4, 12)) * 0.5).astype(np.float32)
    x[3] = 0.0
    return "top_k", {"X": [x]}, {"k": 5}, X


def _top_k_int(r):
    return "top_k", {"X": [r.randint(0, 4, (3, 9)).astype(np.int32)]}, \
        {"k": 4}, ()


def _argmax(op, axis):
    def case(r):
        return op, {"X": [_distinct(r, 3, 4, 7)]}, {"axis": axis}, ()
    return case


def _one_hot(r):
    ids = np.array([[0], [5], [2], [7], [-1], [3]], np.int64)
    return "one_hot", {"X": [ids]}, {"depth": 6}, ()


def _reduce(op, attrs, distinct=False):
    def case(r):
        if distinct:
            x = _distinct(r, 3, 4, 5)
        elif op == "reduce_prod":
            x = (r.rand(3, 4, 5) + 0.5) * np.where(r.rand(3, 4, 5) > 0.5,
                                                   1, -1)
        else:
            x = r.randn(3, 4, 5)
        return op, {"X": [np.asarray(x, np.float32)]}, attrs, X
    return case


CASES = {
    # activation_ops.py
    "logsigmoid": _act("logsigmoid"),
    "relu6": _act("relu6", {"threshold": 6.0}, (0.0, 6.0),
                  x=lambda r: r.randn(3, 5, 7) * 5),
    "abs": _act("abs", kinks=(0.0,)),
    "rsqrt": _act("rsqrt", lo=0.5),
    "round": _act("round", kinks=[k + 0.5 for k in range(-8, 8)],
                  x=lambda r: r.randn(3, 5, 7) * 3),
    "softsign": _act("softsign"),
    "softplus": _act("softplus"),
    "softrelu": _act("softrelu"),
    "sin": _act("sin"),
    "cos": _act("cos"),
    "gelu": _act("gelu"),
    "silu": _act("silu"),
    "swish": _act("swish"),
    "brelu": _act("brelu", {"t_min": -1.0, "t_max": 1.5}, (-1.0, 1.5)),
    "leaky_relu": _act("leaky_relu", {"alpha": 0.1}, (0.0,)),
    "elu": _act("elu", {"alpha": 1.5}, (0.0,)),
    "stanh": _act("stanh", {"scale_a": 0.5, "scale_b": 1.5}),
    "hard_shrink": _act("hard_shrink", {"threshold": 0.5}, (-0.5, 0.5)),
    "soft_shrink": _act("soft_shrink", {"lambda": 0.5}, (-0.5, 0.5)),
    "softshrink": _act("softshrink", {"lambda": 0.3}, (-0.3, 0.3)),
    "thresholded_relu": _act("thresholded_relu", {"threshold": 1.0},
                             (1.0,)),
    "hard_sigmoid": _act("hard_sigmoid", {"slope": 0.2, "offset": 0.5},
                         (-2.5, 2.5), x=lambda r: r.randn(3, 5, 7) * 4),
    "prelu": _prelu("all"),
    "prelu[channel]": _prelu("channel"),
    "prelu[element]": _prelu("element"),
    # nn_ops.py
    "conv2d_transpose": _conv2d_transpose,
    "conv3d": _conv3d,
    "depthwise_conv2d": _depthwise,
    "pool3d": _pool3d("max"),
    "pool3d[avg]": _pool3d("avg"),
    "max_pool2d_with_index": _pool_with_index("max_pool2d_with_index"),
    "pool2d_with_index": _pool_with_index("pool2d_with_index"),
    "unpool": _unpool,
    "layer_norm": _layer_norm(1),
    "layer_norm[begin2]": _layer_norm(2),
    "log_softmax": _log_softmax,
    "softmax_with_cross_entropy": _swce("hard"),
    "softmax_with_cross_entropy[soft]": _swce("soft"),
    "softmax_with_cross_entropy[3d]": _swce("3d"),
    "maxout": _maxout,
    "bilinear_interp": _bilinear(10, 4),
    "bilinear_interp[down]": _bilinear(3, 5),
    "pad_constant_like": _pad_constant_like,
    "spp": _spp("max"),
    "spp[avg]": _spp("avg"),
    "im2sequence": _im2sequence("im2sequence"),
    "block_expand": _im2sequence("block_expand"),
    # loss_ops.py
    "hinge_loss": _hinge,
    "huber_loss": _binary("huber_loss", "X", "Y", _f(8, 3),
                          _f(8, 3, kinks=()), {"delta": 1.0}, wrt_y=True),
    "log_loss": _binary("log_loss", "Predicted", "Labels",
                        lambda r: (r.rand(8, 1) * 0.9 + 0.05).astype(
                            np.float32), _bits(8, 1), {"epsilon": 1e-4}),
    "margin_rank_loss": _margin_rank,
    "rank_loss": _rank_loss,
    "smooth_l1_loss": _smooth_l1,
    "squared_l2_distance": _binary("squared_l2_distance", "X", "Y",
                                   _f(4, 5), _f(4, 5), wrt_y=True),
    "sigmoid_cross_entropy_with_logits": _binary(
        "sigmoid_cross_entropy_with_logits", "X", "Label", _f(6, 4, scale=3),
        lambda r: r.rand(6, 4).astype(np.float32)),
    "modified_huber_loss": _modified_huber,
    "cos_sim": _binary("cos_sim", "X", "Y", _f(4, 6), _f(4, 6), wrt_y=True),
    "bilinear_tensor_product": _bilinear_tp,
    "kldiv_loss": _binary("kldiv_loss", "X", "Target", _f(4, 6),
                          lambda r: r.rand(4, 6).astype(np.float32) + 0.01,
                          {"reduction": "mean"}, wrt_y=True),
    "cross_entropy_over_beam": _ce_over_beam,
    # metric_ops.py
    "accuracy": _accuracy,
    "auc": _auc,
    "precision_recall": _precision_recall,
    "positive_negative_pair": _pnpair,
    # tensor_ops.py and math_ops.py
    "transpose": _transpose,
    "top_k": _top_k,
    "top_k[tied]": _top_k_tied,
    "top_k[int32]": _top_k_int,
    "argmax": _argmax("argmax", -1),
    "arg_max": _argmax("arg_max", 1),
    "max_ids": _argmax("max_ids", 0),
    "one_hot": _one_hot,
    "reduce_sum": _reduce("reduce_sum", {"dim": [1], "keep_dim": False}),
    "reduce_mean": _reduce("reduce_mean", {"dim": [0, 2], "keep_dim": True}),
    "reduce_max": _reduce("reduce_max", {"dim": [-1]}, distinct=True),
    "reduce_min": _reduce("reduce_min", {"dim": [0, 1], "keep_dim": True},
                          distinct=True),
    "reduce_prod": _reduce("reduce_prod", {"dim": [2]}),
    "reduce_sum[all]": _reduce("reduce_sum", {"reduce_all": True}),
    "reduce_max[all]": _reduce("reduce_max", {"reduce_all": True,
                                              "keep_dim": True},
                               distinct=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    """fp32 forward, output dtypes and input gradients."""
    op, ins, attrs, wrt = CASES[name](_rng(name))
    _check(op, ins, attrs, "float32", wrt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_in_bf16(name):
    """The AMP compute dtype: float inputs in bf16, the same output
    dtypes as JAX's, values within 2^-7 of each output's scale."""
    op, ins, attrs, _ = CASES[name](_rng(name))
    _check(op, ins, attrs, "bfloat16")


def test_every_ported_dense_op_has_a_case():
    """Each op name the slice ports (the four families, with aliases, and
    the tensor and math ops it brings) is covered above."""
    import importlib
    names = set()
    for fam in ("activation_ops", "nn_ops", "loss_ops", "metric_ops"):
        mod = importlib.import_module(f"paddle_tpu.ops.{fam}")
        src = open(mod.__file__).read()
        import re
        for m in re.finditer(r"register_op\(([^)]*)\)", src):
            names |= set(re.findall(r'"([a-z0-9_]+)"', m.group(1)))
    names |= {"transpose", "top_k", "argmax", "arg_max", "max_ids",
              "one_hot", "reduce_sum", "reduce_mean", "reduce_max",
              "reduce_min", "reduce_prod"}
    covered = {n.split("[")[0] for n in CASES} | {"lambda_rank"}
    from paddle_tpu_torch.core import registry
    ported = set(registry.registered_ops())
    assert names <= ported, sorted(names - ported)
    # the ops of earlier slices have their cases elsewhere
    earlier = {"sigmoid", "tanh", "relu", "sqrt", "square", "exp", "log",
               "floor", "ceil", "reciprocal", "conv2d", "pool2d",
               "batch_norm", "softmax", "cross_entropy", "dropout", "lrn",
               "mse_loss", "squared_l2_norm"}
    assert names - earlier <= covered, sorted(names - earlier - covered)


# ---------------------------------------------------------------------------
# lambda_rank: lengths from @LEN, the lambda gradient
# ---------------------------------------------------------------------------
def _np_lambda_ref(o, s, k, max_sort_size=-1):
    """A numpy port of the reference's LambdaCost::calcNDCG and calcGrad
    (``tests/test_lambda_rank.py``)."""
    n = len(o)
    order = np.argsort(-s, kind="stable")
    sort_size = n if max_sort_size < 0 else min(max_sort_size, n)
    max_dcg = sum((2.0 ** s[order[i]] - 1) / np.log(i + 2)
                  for i in range(min(k, n)))
    oorder = np.argsort(-o, kind="stable")
    dcg = sum((2.0 ** s[oorder[i]] - 1) / np.log(i + 2)
              for i in range(min(k, n)))
    grad = np.zeros(n)
    for i in range(sort_size):
        for j in range(i + 1, n):
            ii, jj = order[i], order[j]
            if j < sort_size:
                dif = (2.0 ** s[ii] - 2.0 ** s[jj]) * \
                    (1 / np.log(i + 2) - 1 / np.log(j + 2))
            else:
                dif = (2.0 ** s[ii] - 2.0 ** s[jj]) / np.log(i + 2)
            lam = -abs(dif) / (1 + np.exp(o[ii] - o[jj]))
            grad[ii] += lam / max_dcg
            grad[jj] -= lam / max_dcg
    return dcg / max_dcg, grad


def _lambda_program(k, mss):
    prog = pt.Program()
    gb = prog.global_block()
    for n in ("score", "label", "out"):
        gb.create_var(name=n, lod_level=1 if n != "out" else 0)
    gb.append_op("lambda_rank", {"Score": ["score"], "Label": ["label"]},
                 {"Out": ["out"]}, {"ndcg_num": k, "max_sort_size": mss})
    return prog


@pytest.mark.parametrize("mss", [-1, 4])
def test_lambda_rank_matches_jax_and_the_reference(mss):
    """Forward NDCG@k [B, 1] fp32 and the lambda gradient (not the
    NDCG's own) against the JAX op's custom VJP and the numpy port of
    the reference, over ragged groups given by ``score@LEN``."""
    r = _rng(f"lambda{mss}")
    B, M, k = 3, 7, 3
    o = _distinct(r, B, M, 1)
    s = r.randint(0, 4, (B, M, 1)).astype(np.float32)
    lens = np.array([7, 5, 2], np.int32)
    prog = _lambda_program(k, mss)
    tprog = ptt.Program.from_json(prog.to_json())

    def jrun(ov):
        env = pt.core.Env(prog.global_block())
        env.local.update({"score": ov, "label": jnp.asarray(s),
                          "score@LEN": jnp.asarray(lens)})
        pt.core.interpret_ops(prog.global_block().ops, env,
                              pt.core.LoweringContext(
                                  prog, jax.random.PRNGKey(0)))
        return env.get("out")

    jout = jrun(jnp.asarray(o))
    cot = r.randn(B, 1).astype(np.float32)
    jg = np.asarray(jax.grad(lambda ov: jnp.sum(jrun(ov) * cot))(
        jnp.asarray(o)))
    leaf = torch.from_numpy(o).requires_grad_(True)
    tenv = ptt.core.Env(tprog.global_block())
    tenv.local.update({"score": leaf, "label": torch.from_numpy(s),
                       "score@LEN": torch.from_numpy(lens)})
    with torch.enable_grad():
        ptt.core.interpret_ops(tprog.global_block().ops, tenv,
                               ptt.core.ExecContext(tprog,
                                                    torch.device("cpu"), 0))
        tout = tenv.get("out")
        tg, = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                                  [leaf])
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (B, 1)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tg.numpy(), jg, **TOL)
    for b, n in enumerate(lens):
        nd, g = _np_lambda_ref(o[b, :n, 0].astype(np.float64),
                               s[b, :n, 0].astype(np.float64), k, mss)
        np.testing.assert_allclose(tout[b, 0].item(), nd, rtol=1e-5)
        np.testing.assert_allclose(tg.numpy()[b, :n, 0], g * cot[b, 0],
                                   rtol=1e-4, atol=1e-6)
        assert not tg.numpy()[b, n:].any()


def test_ops_run_on_the_tensors_device_with_no_host_sync():
    """The metric and index ops make their constants on the operand's
    device (a captured step may hold them): a meta tensor flows through
    with no host read."""
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("meta"), 0)
    idx = torch.empty((8, 5), dtype=torch.int64, device="meta")
    label = torch.empty((8, 1), dtype=torch.int64, device="meta")
    out = torch_impl("accuracy")(ctx, {"Indices": [idx], "Label": [label]},
                                 {})
    assert {k: (v.device.type, v.dtype, tuple(v.shape))
            for k, v in out.items()} == {
        "Accuracy": ("meta", torch.float32, (1,)),
        "Correct": ("meta", torch.int32, (1,)),
        "Total": ("meta", torch.int32, (1,))}
    ids = torch.empty((8, 1), dtype=torch.int64, device="meta")
    oh = torch_impl("one_hot")(ctx, {"X": [ids]}, {"depth": 10})["Out"]
    assert oh.device.type == "meta" and tuple(oh.shape) == (8, 10)
    x = torch.empty((8, 50), device="meta")
    tk = torch_impl("top_k")(ctx, {"X": [x]}, {"k": 5})
    assert tk["Indices"].dtype == torch.int64 and \
        tuple(tk["Out"].shape) == (8, 5)


# ---------------------------------------------------------------------------
# The JAX package's numpy references (tests/test_ops_nn.py, test_ops_math.py,
# test_ops_misc.py), on the port's ops
# ---------------------------------------------------------------------------
NR = np.random.RandomState(5)


def _port(op, ins, attrs=None):
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                               is_test=True)
    out = torch_impl(op)(ctx, {k: [torch.from_numpy(np.asarray(v))
                                   for v in vs] for k, vs in ins.items()},
                         dict(attrs or {}))
    return {k: v.numpy() for k, v in out.items()}


def _np_softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


ACT_REF = {
    "abs": np.abs,
    "softplus": lambda x: np.log1p(np.exp(x)),
    "softsign": lambda x: x / (1 + np.abs(x)),
    "round": np.round,
    "rsqrt": lambda x: 1 / np.sqrt(x),
    "sin": np.sin,
    "cos": np.cos,
    "logsigmoid": lambda x: -np.log1p(np.exp(-x)),
}


@pytest.mark.parametrize("op", sorted(ACT_REF))
def test_activation_matches_numpy(op):
    x = NR.uniform(0.2, 2.0, (3, 5)).astype("float32")
    np.testing.assert_allclose(_port(op, {"X": [x]})["Out"], ACT_REF[op](x),
                               atol=1e-4)


def test_leaky_relu_and_elu_match_numpy():
    x = _away(NR.uniform(-2, 2, (3, 4)), [0.0])
    np.testing.assert_allclose(
        _port("leaky_relu", {"X": [x]}, {"alpha": 0.1})["Out"],
        np.where(x > 0, x, 0.1 * x), **TOL)
    np.testing.assert_allclose(
        _port("elu", {"X": [x]}, {"alpha": 1.0})["Out"],
        np.where(x > 0, x, np.expm1(x)), **TOL)


RED = {"reduce_sum": np.sum, "reduce_mean": np.mean,
       "reduce_max": np.max, "reduce_min": np.min, "reduce_prod": np.prod}


@pytest.mark.parametrize("op", sorted(RED))
@pytest.mark.parametrize("dim,keep", [([0], False), ([1], True),
                                      (None, False)])
def test_reduce_matches_numpy(op, dim, keep):
    x = NR.uniform(0.5, 1.5, (3, 4)).astype("float32")
    attrs = {"keep_dim": keep}
    if dim is None:
        attrs["reduce_all"] = True
        want = RED[op](x, keepdims=keep)
    else:
        attrs["dim"] = dim
        want = RED[op](x, axis=tuple(dim), keepdims=keep)
    got = _port(op, {"X": [x]}, attrs)["Out"]
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, **TOL)


def test_top_k_and_one_hot_match_numpy():
    x = _distinct(NR, 3, 6)
    idx = np.argsort(-x, axis=1)[:, :2]
    got = _port("top_k", {"X": [x]}, {"k": 2})
    np.testing.assert_array_equal(got["Indices"], idx)
    np.testing.assert_array_equal(got["Out"], np.take_along_axis(x, idx, 1))
    ids = np.array([[1], [0], [3]])
    want = np.zeros((3, 4), "float32")
    want[np.arange(3), ids[:, 0]] = 1
    np.testing.assert_array_equal(
        _port("one_hot", {"X": [ids]}, {"depth": 4})["Out"], want)


def test_conv2d_transpose_is_the_convolutions_input_gradient():
    """x [1, 2, 3, 3], k 3, s 2 -> [1, 4, 7, 7], equal to the gradient of
    a convolution by Filter with respect to its input."""
    x = NR.rand(1, 2, 3, 3).astype("float32")
    w = NR.rand(2, 4, 3, 3).astype("float32")    # [C_in, C_out, kh, kw]
    got = _port("conv2d_transpose", {"Input": [x], "Filter": [w]},
                {"strides": [2, 2], "paddings": [0, 0]})["Output"]
    assert got.shape == (1, 4, 7, 7)
    want = torch.nn.grad.conv2d_input((1, 4, 7, 7), torch.from_numpy(w),
                                      torch.from_numpy(x), stride=2)
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_layer_norm_and_softmax_with_cross_entropy_match_numpy():
    x = NR.rand(4, 6).astype("float32")
    scale, bias = NR.rand(6).astype("float32"), NR.rand(6).astype("float32")
    mu, v = x.mean(1, keepdims=True), x.var(1, keepdims=True)
    got = _port("layer_norm", {"X": [x], "Scale": [scale], "Bias": [bias]},
                {"epsilon": 1e-5, "begin_norm_axis": 1})
    np.testing.assert_allclose(
        got["Y"], (x - mu) / np.sqrt(v + 1e-5) * scale + bias, atol=1e-4)
    np.testing.assert_allclose(got["Mean"], mu[:, 0], **TOL)
    np.testing.assert_allclose(got["Variance"], v[:, 0], **TOL)
    logits = NR.rand(4, 5).astype("float32")
    lbl = np.array([[0], [3], [2], [4]])
    p = _np_softmax(logits)
    got = _port("softmax_with_cross_entropy",
                {"Logits": [logits], "Label": [lbl]})
    np.testing.assert_allclose(got["Softmax"], p, atol=1e-6)
    np.testing.assert_allclose(
        got["Loss"], -np.log(p[np.arange(4), lbl[:, 0]]).reshape(4, 1),
        atol=1e-5)


def test_losses_match_numpy():
    x = NR.uniform(-2, 2, (4, 3)).astype("float32")
    lbl = NR.rand(4, 3).astype("float32")
    sig = 1 / (1 + np.exp(-x))
    np.testing.assert_allclose(
        _port("sigmoid_cross_entropy_with_logits",
              {"X": [x], "Label": [lbl]})["Out"],
        -lbl * np.log(sig) - (1 - lbl) * np.log(1 - sig), atol=1e-4)
    p = NR.uniform(0.1, 0.9, (4, 1)).astype("float32")
    y = NR.randint(0, 2, (4, 1)).astype("float32")
    np.testing.assert_allclose(
        _port("log_loss", {"Predicted": [p], "Labels": [y]},
              {"epsilon": 1e-4})["Loss"],
        -y * np.log(p + 1e-4) - (1 - y) * np.log(1 - p + 1e-4), atol=1e-4)
    t = NR.uniform(-2, 2, (4, 3)).astype("float32")
    d = np.abs(x - t)
    np.testing.assert_allclose(
        _port("huber_loss", {"X": [x], "Y": [t]}, {"delta": 1.0})["Out"],
        np.where(d <= 1.0, 0.5 * d ** 2, d - 0.5), atol=1e-4)
    a, b = NR.rand(4, 3).astype("float32"), NR.rand(4, 3).astype("float32")
    np.testing.assert_allclose(
        _port("squared_l2_distance", {"X": [a], "Y": [b]})["Out"],
        ((a - b) ** 2).sum(1, keepdims=True), atol=1e-5)
    np.testing.assert_allclose(
        _port("cos_sim", {"X": [a], "Y": [b]})["Out"],
        (a * b).sum(1, keepdims=True) / (
            np.linalg.norm(a, axis=1, keepdims=True)
            * np.linalg.norm(b, axis=1, keepdims=True)), atol=1e-5)


def test_metric_ops_match_their_definitions():
    """accuracy one wrong of six; AUC within 0.02 of the pairwise AUC;
    micro precision of the indices; the pairs a query's scores keep or
    reverse."""
    pred = _np_softmax(NR.rand(6, 4).astype("float32"))
    lbl = np.argmax(pred, 1).reshape(-1, 1)
    lbl[0] = (lbl[0] + 1) % 4
    got = _port("accuracy", {"Out": [pred], "Label": [lbl],
                             "Indices": [np.argsort(-pred, 1)[:, :1]]})
    np.testing.assert_allclose(got["Accuracy"], 5 / 6, atol=1e-6)
    assert got["Correct"].tolist() == [5] and got["Total"].tolist() == [6]
    n = 200
    label = NR.randint(0, 2, (n, 1))
    score = np.clip(label[:, 0] * 0.3 + NR.rand(n) * 0.7, 0, 1)
    pp = np.stack([1 - score, score], 1).astype("float32")
    auc = float(_port("auc", {"Predict": [pp], "Label": [label]},
                      {"num_thresholds": 200})["AUC"][0])
    pos, neg = score[label[:, 0] == 1], score[label[:, 0] == 0]
    pairs = (pos[:, None] > neg[None, :]).mean() + \
        0.5 * (pos[:, None] == neg[None, :]).mean()
    assert abs(auc - pairs) < 0.02, (auc, pairs)
    m = _port("precision_recall",
              {"Indices": [np.array([0, 1, 1, 2, 2, 2]).reshape(-1, 1)],
               "Labels": [np.array([0, 1, 2, 2, 2, 0]).reshape(-1, 1)]},
              {"class_number": 3})["BatchMetrics"]
    np.testing.assert_allclose(m[3], 4 / 6, atol=1e-6)
    got = _port("positive_negative_pair", {
        "Score": [np.array([0.9, 0.8, 0.85, 0.3, 0.6], "float32")
                  .reshape(-1, 1)],
        "Label": [np.array([2, 1, 0, 1, 0], "float32").reshape(-1, 1)],
        "QueryID": [np.array([0, 0, 0, 1, 1]).reshape(-1, 1)]})
    assert got["PositivePair"].tolist() == [2.0]
    assert got["NegativePair"].tolist() == [2.0]
