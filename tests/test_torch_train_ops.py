"""The training ops of the port against their JAX lowerings, forward and
gradient (``jax.grad`` against autograd), on the same numpy-seeded
inputs in fp32: batch norm on batch statistics, cross entropy, mean,
sgd and momentum, and the ops the regularizers and clips emit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl

R = np.random.RandomState(21)
TOL = dict(rtol=1e-5, atol=1e-6)


def _ctxs(is_test=False):
    jctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(0),
                                   is_test=is_test)
    tctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                                is_test=is_test)
    return jctx, tctx


def _both(op, ins, attrs, wrt=(), out_slot=None, weights=None,
          is_test=False):
    """Run ``op`` in both packages.  Returns ({slot: np} jax, {slot: np}
    torch, [jax grads], [torch grads]) where the grads are of
    sum(out[out_slot] * weights) with respect to the ``wrt`` inputs
    (slot names, first tensor of each)."""
    jctx, tctx = _ctxs(is_test)

    def jfun(*vals):
        jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
        for slot, v in zip(wrt, vals):
            jins[slot] = [v] + jins[slot][1:]
        return jax_impl(op)(jctx, jins, dict(attrs))

    jout = jfun(*[jnp.asarray(ins[s][0]) for s in wrt])
    tins = {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    leaves = []
    for s in wrt:
        tins[s][0] = tins[s][0].requires_grad_(True)
        leaves.append(tins[s][0])
    tout = torch_impl(op)(tctx, tins, dict(attrs))
    jg, tg = [], []
    if wrt:
        w = weights if weights is not None else \
            R.randn(*np.shape(jout[out_slot])).astype("float32")
        jg = jax.grad(lambda *v: jnp.sum(jfun(*v)[out_slot] * w),
                      argnums=tuple(range(len(wrt))))(
            *[jnp.asarray(ins[s][0]) for s in wrt])
        jg = [np.asarray(g) for g in jg]
        (tout[out_slot] * torch.from_numpy(np.array(w))).sum().backward()
        tg = [leaf.grad.numpy() for leaf in leaves]
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.detach().float().numpy() for k, v in tout.items()}, jg, tg)


def _x(*shape):
    return R.randn(*shape).astype("float32")


@pytest.mark.parametrize("shape", [(4, 8, 6, 6), (32, 16)])
def test_batch_norm_train_matches_jax(shape):
    """Batch statistics (single-pass fp32, clamp at 0), the running
    averages, SavedMean/SavedVariance, and the gradients of x, scale and
    bias through the statistics."""
    c = shape[1]
    x = _x(*shape) * 2 + 0.5
    ins = {"X": [x], "Scale": [_x(c)], "Bias": [_x(c)],
           "Mean": [_x(c)], "Variance": [np.abs(_x(c)) + 0.5]}
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "is_test": False}
    j, t, jg, tg = _both("batch_norm", ins, attrs,
                         wrt=("X", "Scale", "Bias"), out_slot="Y")
    for slot in ("Y", "MeanOut", "VarianceOut", "SavedMean",
                 "SavedVariance"):
        np.testing.assert_allclose(t[slot], j[slot], rtol=1e-5, atol=1e-5,
                                   err_msg=slot)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_batch_norm_float64_keeps_float64():
    """A float64 input keeps float64 statistics (the exact witness a
    training check can hold fp32 runs against): Y equals numpy's float64
    batch norm far below fp32 rounding."""
    x = R.randn(4, 8, 6, 6) * 2 + 0.5
    scale, bias = R.randn(8), R.randn(8)
    ins = {"X": [torch.from_numpy(x)], "Scale": [torch.from_numpy(scale)],
           "Bias": [torch.from_numpy(bias)],
           "Mean": [torch.zeros(8, dtype=torch.float64)],
           "Variance": [torch.ones(8, dtype=torch.float64)]}
    _, tctx = _ctxs()
    out = torch_impl("batch_norm")(tctx, ins, {"epsilon": 1e-5,
                                               "momentum": 0.9})
    mu = x.mean((0, 2, 3), keepdims=True)
    var = ((x - mu) ** 2).mean((0, 2, 3), keepdims=True)
    ref = (x - mu) / np.sqrt(var + 1e-5) * scale.reshape(1, -1, 1, 1) \
        + bias.reshape(1, -1, 1, 1)
    for slot in ("Y", "SavedMean", "SavedVariance", "MeanOut"):
        assert out[slot].dtype == torch.float64, slot
    np.testing.assert_allclose(out["Y"].numpy(), ref, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("use_global,is_test", [(None, True), (True, False),
                                                (False, True)])
def test_batch_norm_stat_routing_matches_jax(use_global, is_test):
    """use_global_stats overrides is_test; a test pass never advances the
    running averages."""
    x = _x(4, 8, 5, 5)
    ins = {"X": [x], "Scale": [_x(8)], "Bias": [_x(8)], "Mean": [_x(8)],
           "Variance": [np.abs(_x(8)) + 0.5]}
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "is_test": is_test,
             "use_global_stats": use_global}
    j, t, _, _ = _both("batch_norm", ins, attrs, is_test=is_test)
    for slot in ("Y", "MeanOut", "VarianceOut", "SavedVariance"):
        np.testing.assert_allclose(t[slot], j[slot], rtol=1e-5, atol=1e-5,
                                   err_msg=slot)


@pytest.mark.parametrize("label_shape", [(8, 1), (8,)])
def test_cross_entropy_hard_label_matches_jax(label_shape):
    p = np.abs(_x(8, 10)) + 1e-3
    p /= p.sum(1, keepdims=True)
    p[0, 3] = 0.0                       # the eps clamp
    lab = R.randint(0, 10, label_shape)
    lab.reshape(-1)[0] = 3
    j, t, jg, tg = _both("cross_entropy", {"X": [p], "Label": [lab]},
                         {"soft_label": False}, wrt=("X",), out_slot="Y")
    assert t["Y"].shape == (8, 1)
    np.testing.assert_allclose(t["Y"], j["Y"], **TOL)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-5, atol=1e-5)


def test_cross_entropy_soft_label_matches_jax():
    p = np.abs(_x(6, 5)) + 1e-2
    p /= p.sum(1, keepdims=True)
    lab = np.abs(_x(6, 5))
    lab /= lab.sum(1, keepdims=True)
    j, t, jg, tg = _both("cross_entropy", {"X": [p], "Label": [lab]},
                         {"soft_label": True}, wrt=("X",), out_slot="Y")
    np.testing.assert_allclose(t["Y"], j["Y"], **TOL)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-5, atol=1e-5)


def test_mean_matches_jax():
    x = _x(7, 3)
    j, t, jg, tg = _both("mean", {"X": [x]}, {}, wrt=("X",), out_slot="Out",
                         weights=np.float32(1.0))
    assert t["Out"].shape == ()
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_jax(nesterov):
    ins = {"Param": [_x(5, 4)], "Grad": [_x(5, 4)], "Velocity": [_x(5, 4)],
           "LearningRate": [np.array([0.05], "float32")]}
    j, t, _, _ = _both("momentum", ins, {"mu": 0.9,
                                         "use_nesterov": nesterov})
    for slot in ("ParamOut", "VelocityOut"):
        np.testing.assert_allclose(t[slot], j[slot], **TOL)


def test_sgd_matches_jax():
    ins = {"Param": [_x(6)], "Grad": [_x(6)],
           "LearningRate": [np.array([0.1], "float32")]}
    j, t, _, _ = _both("sgd", ins, {})
    np.testing.assert_allclose(t["ParamOut"], j["ParamOut"], **TOL)


UNARY = [
    ("scale", {"scale": 0.5, "bias": 0.25}),
    ("scale", {"scale": 0.5, "bias": 0.25, "bias_after_scale": False}),
    ("sign", {}),
    ("sqrt", {}),
    ("clip", {"min": -0.3, "max": 0.4}),
    ("clip_by_norm", {"max_norm": 0.5}),
    ("clip_by_norm", {"max_norm": 100.0}),
    ("squared_l2_norm", {}),
    ("increment", {"step": 2.0}),
]


@pytest.mark.parametrize("op,attrs", UNARY,
                         ids=[f"{o}{i}" for i, (o, _) in enumerate(UNARY)])
def test_unary_ops_match_jax(op, attrs):
    x = _x(4, 6)
    if op == "sqrt":
        x = np.abs(x) + 0.1
    wrt = () if op in ("sign", "increment") else ("X",)
    j, t, jg, tg = _both(op, {"X": [x]}, attrs, wrt=wrt, out_slot="Out")
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_increment_keeps_integer_dtype():
    _, tctx = _ctxs()
    out = torch_impl("increment")(
        tctx, {"X": [torch.tensor([3], dtype=torch.int64)]}, {"step": 1.0})
    assert out["Out"].dtype == torch.int64 and out["Out"].item() == 4


@pytest.mark.parametrize("op", ["elementwise_sub", "elementwise_mul",
                                "elementwise_div", "elementwise_max",
                                "elementwise_min"])
def test_elementwise_ops_match_jax(op):
    x, y = _x(2, 3, 4), np.abs(_x(3)) + 0.5
    j, t, jg, tg = _both(op, {"X": [x], "Y": [y]}, {"axis": 1},
                         wrt=("X", "Y"), out_slot="Out")
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_sum_matches_jax():
    xs = [_x(3, 2) for _ in range(3)]
    j, t, _, _ = _both("sum", {"X": xs}, {})
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)
