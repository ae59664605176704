"""Optimizer ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``:
sgd, momentum, adam, adamax, adagrad, adadelta, decayed_adagrad,
rmsprop, ftrl, proximal_gd and proximal_adagrad).  As in the JAX
package, an update is an op of the program: it reads the parameter, its
gradient and its accumulators and produces new values, which the
executor writes back to the scope in the dtype the scope held.

Under the executor's AMP the accumulators and a persistable learning
rate arrive as bf16 copies (the forward's copies of the state), as in
the JAX package; each op computes from them what the JAX op computes,
with the same type promotions (a bf16 accumulator meeting the fp32
gradient computes in fp32) and the same constants: a Python number
meeting a bf16 tensor is rounded to bf16 first, as JAX's weak typing
does (so beta2 = 0.999 multiplies a bf16 accumulator as 1.0)."""
from __future__ import annotations

import functools

import torch

from ..core.registry import register_op, register_tunable

# A pending kernel candidate (the JAX package's optimizer_ops.py:29), with
# a rule of its own for the card: the optimizer step is pure memory
# traffic (every parameter and moment read and written once, a few
# flops), so the per-parameter ops pay one HBM round trip a tensor.  The
# candidate is one hand-written CUDA kernel over all parameters.  No
# kernel exists in either package; opprof's report names this rule where
# optimizer-update op classes dominate a measured profile.
register_tunable(
    "cuda/fused_optimizer_update", side="device",
    space={"fused": (False, True), "block_elems": (4096, 8192, 16384)},
    default={"fused": False, "block_elems": 8192},
    description="fuse the per-parameter optimizer update ops (sgd/"
                "momentum/adam/... families) into one CUDA kernel over "
                "every parameter; block_elems is a block's slab",
    pending_hardware=True,
    decision_rule="flip fused=True only when an on-card paired A/B over "
                  "a captured training step (benchmark.opprof "
                  "workloads, H100) shows >= 1.10x median step time with "
                  ">= 75% of pairs favoring, AND the opprof per-op table "
                  "attributes >= 10% of the step's measured device time "
                  "to optimizer-update op classes (else the fusion "
                  "cannot pay: the step's bytes bound it at 3.35 TB/s)")


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _k(c, t):
    """The constant ``c`` as it meets tensor ``t`` in the JAX op: rounded
    to ``t``'s dtype when that is a 16-bit float, else as it is."""
    return _rounded(float(c), t.dtype) if t.dtype in (
        torch.bfloat16, torch.float16) else c


@functools.lru_cache(maxsize=None)
def _rounded(c, dtype):
    return float(torch.tensor(c, dtype=dtype))


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": p - _lr(ins) * g}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    v_out = _k(mu, v) * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + _k(mu, v_out) * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam")
def _adam(ctx, ins, attrs):
    """Adam (``optimizer_ops.py:68-105``): bias-corrected step
    lr * sqrt(1 - beta2^t) / (1 - beta1^t), and the beta pows advanced
    by one step (Beta1PowOut, Beta2PowOut).

    Under the executor's AMP the accumulators and the learning rate
    arrive as bf16 copies, as in the JAX package; bf16(0.999) is 1.0,
    so 1 - Beta2Pow is 0 and the step leaves the parameter unchanged in
    both packages.

    ``lazy_mode`` with ``Rows`` (the ids of the ``lookup_table`` ops
    that are the parameter's only readers; adam_op.cc's lazy_mode):
    only those rows update, the rest keep their moments.  The dense
    gradient row already sums an id's duplicates, so duplicates write
    equal values."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    out = {"Beta1PowOut": (b1p * _k(b1, b1p)).reshape(1),
           "Beta2PowOut": (b2p * _k(b2, b2p)).reshape(1)}
    if attrs.get("lazy_mode") and "Rows" in ins:
        ids = torch.cat([i.reshape(-1) for i in ins["Rows"]]).long()
        g_r = g[ids]
        m_r = _k(b1, m) * m[ids] + (1 - b1) * g_r
        v_r = _k(b2, v) * v[ids] + (1 - b2) * torch.square(g_r)
        p_r = p[ids] - lr_t * m_r / (torch.sqrt(v_r) + eps)
        out.update({
            "ParamOut": p.index_put((ids,), p_r.to(p.dtype)),
            "Moment1Out": m.index_put((ids,), m_r.to(m.dtype)),
            "Moment2Out": v.index_put((ids,), v_r.to(v.dtype))})
        return out
    m_out = _k(b1, m) * m + (1 - b1) * g
    v_out = _k(b2, v) * v + (1 - b2) * torch.square(g)
    out.update({"ParamOut": p - lr_t * m_out / (torch.sqrt(v_out) + eps),
                "Moment1Out": m_out, "Moment2Out": v_out})
    return out


@register_op("adamax")
def _adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = _k(b1, m) * m + (1 - b1) * g
    inf_out = torch.maximum(_k(b2, inf) * inf, torch.abs(g))
    p_out = p - (_lr(ins) / (1 - b1p)) * m_out / (inf_out + eps)
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out,
            "Beta1PowOut": (b1p * _k(b1, b1p)).reshape(1)}


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    m_out = mom + torch.square(g)
    return {"ParamOut": p - _lr(ins) * g / (torch.sqrt(m_out) + eps),
            "MomentOut": m_out}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    """The learning rate is not read, as in the JAX op."""
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq_g, avg_sq_u = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = _k(rho, avg_sq_g) * avg_sq_g + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((avg_sq_u + _k(eps, avg_sq_u)) / (g2 + eps)) * g
    u2 = _k(rho, avg_sq_u) * avg_sq_u + (1 - rho) * torch.square(upd)
    return {"ParamOut": p + upd, "AvgSquaredGradOut": g2,
            "AvgSquaredUpdateOut": u2}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = _k(decay, mom) * mom + (1 - decay) * torch.square(g)
    return {"ParamOut": p - _lr(ins) * g / (torch.sqrt(m_out) + eps),
            "MomentOut": m_out}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    mu = attrs.get("momentum", 0.0)
    eps = attrs.get("epsilon", 1e-6)
    ms_out = _k(rho, ms) * ms + (1 - rho) * torch.square(g)
    mom_out = _k(mu, mom) * mom + _lr(ins) * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": p - mom_out, "MomentOut": mom_out,
            "MeanSquareOut": ms_out}


@register_op("ftrl")
def _ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq_acc, lin_acc = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq_acc + torch.square(g)
    sigma = (torch.pow(new_sq, -power)
             - torch.pow(sq_acc, _k(-power, sq_acc))) / lr
    new_lin = lin_acc + g - sigma * p
    denom = torch.pow(new_sq, -power) / lr + 2 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    return {"ParamOut": pre / denom, "SquaredAccumOut": new_sq,
            "LinearAccumOut": new_lin}


def _shrink(prox, lr, l1):
    """The l1 proximal step: sign(x) * max(|x| - lr * l1, 0)."""
    if l1 > 0:
        prox = torch.sign(prox) * torch.clamp(
            torch.abs(prox) - lr * _k(l1, lr), min=0.0)
    return prox


@register_op("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr = _lr(ins)
    prox = _shrink(p - lr * g, lr, l1)
    return {"ParamOut": prox / (1.0 + lr * _k(l2, lr))}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    m_out = mom + torch.square(g)
    eff_lr = _lr(ins) / torch.sqrt(m_out)
    prox = _shrink(p - eff_lr * g, eff_lr, l1)
    return {"ParamOut": prox / (1.0 + eff_lr * l2), "MomentOut": m_out}


# ---------------------------------------------------------------------------
# Static shape/dtype rules: every optimizer op mirrors its state inputs to
# the matching *Out slots (the reference's Param/Grad same-dims CHECKs in
# sgd_op.cc etc. become an explicit Param-vs-Grad shape check).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, first, mirror,  # noqa: E402
                                    shapes_compatible)
from ..core.registry import register_shape_fn  # noqa: E402


def _opt_rule(mapping):
    base = mirror(mapping)

    def rule(op, ins, attrs):
        p, g = first(ins, "Param"), first(ins, "Grad")
        if not shapes_compatible(p.shape, g.shape):
            raise ShapeError(
                f"Param {list(p.shape)} vs Grad {list(g.shape)} dims differ")
        return base(op, ins, attrs)

    return rule


register_shape_fn("sgd")(_opt_rule({"ParamOut": "Param"}))
register_shape_fn("momentum")(_opt_rule(
    {"ParamOut": "Param", "VelocityOut": "Velocity"}))
register_shape_fn("adam")(_opt_rule(
    {"ParamOut": "Param", "Moment1Out": "Moment1", "Moment2Out": "Moment2",
     "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow"}))
register_shape_fn("adamax")(_opt_rule(
    {"ParamOut": "Param", "MomentOut": "Moment", "InfNormOut": "InfNorm",
     "Beta1PowOut": "Beta1Pow"}))
register_shape_fn("adagrad", "decayed_adagrad", "proximal_adagrad")(
    _opt_rule({"ParamOut": "Param", "MomentOut": "Moment"}))
register_shape_fn("adadelta")(_opt_rule(
    {"ParamOut": "Param", "AvgSquaredGradOut": "AvgSquaredGrad",
     "AvgSquaredUpdateOut": "AvgSquaredUpdate"}))
register_shape_fn("rmsprop")(_opt_rule(
    {"ParamOut": "Param", "MomentOut": "Moment",
     "MeanSquareOut": "MeanSquare"}))
register_shape_fn("ftrl")(_opt_rule(
    {"ParamOut": "Param", "SquaredAccumOut": "SquaredAccumulator",
     "LinearAccumOut": "LinearAccumulator"}))
register_shape_fn("proximal_gd")(_opt_rule({"ParamOut": "Param"}))


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop): every optimizer op
# keeps its state on the parameter's sharding (the dp-reduced gradient
# arrives in the param's layout; accumulators ride along), with the
# Param-vs-Grad merge surfacing layout mismatches as PT041.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import shard_mirror  # noqa: E402
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("sgd", "proximal_gd")(shard_mirror(
    {"ParamOut": "Param"}, check_grad=True))
register_shard_fn("momentum")(shard_mirror(
    {"ParamOut": "Param", "VelocityOut": "Velocity"}, check_grad=True))
register_shard_fn("adam")(shard_mirror(
    {"ParamOut": "Param", "Moment1Out": "Moment1",
     "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
     "Beta2PowOut": "Beta2Pow"}, check_grad=True))
register_shard_fn("adamax")(shard_mirror(
    {"ParamOut": "Param", "MomentOut": "Moment", "InfNormOut": "InfNorm",
     "Beta1PowOut": "Beta1Pow"}, check_grad=True))
register_shard_fn("adagrad", "decayed_adagrad", "proximal_adagrad")(
    shard_mirror({"ParamOut": "Param", "MomentOut": "Moment"},
                 check_grad=True))
register_shard_fn("adadelta")(shard_mirror(
    {"ParamOut": "Param", "AvgSquaredGradOut": "AvgSquaredGrad",
     "AvgSquaredUpdateOut": "AvgSquaredUpdate"}, check_grad=True))
register_shard_fn("rmsprop")(shard_mirror(
    {"ParamOut": "Param", "MomentOut": "Moment",
     "MeanSquareOut": "MeanSquare"}, check_grad=True))
register_shard_fn("ftrl")(shard_mirror(
    {"ParamOut": "Param", "SquaredAccumOut": "SquaredAccumulator",
     "LinearAccumOut": "LinearAccumulator"}, check_grad=True))
