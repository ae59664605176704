"""Optimizer ops (counterpart of ``sgd``, ``momentum`` and ``adam`` in
``paddle_tpu/ops/optimizer_ops.py``).  As in the JAX package, an update
is an op of the program: it reads the parameter, its gradient and its
accumulators and produces new values, which the executor writes back to
the scope.  The other optimizers come with the slices that use them."""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": p - _lr(ins) * g}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam")
def _adam(ctx, ins, attrs):
    """Dense Adam (``optimizer_ops.py:68-105``): bias-corrected step
    lr * sqrt(1 - beta2^t) / (1 - beta1^t), and the beta pows advanced
    by one step (Beta1PowOut, Beta2PowOut).

    Under the executor's AMP the accumulators and the learning rate
    arrive as bf16 copies, as in the JAX package; bf16(0.999) is 1.0,
    so 1 - Beta2Pow is 0 and the step leaves the parameter unchanged in
    both packages.  ``lazy_mode`` (rows of the batch only) comes with
    the sparse slice."""
    if attrs.get("lazy_mode") and "Rows" in ins:
        raise NotImplementedError(
            "adam lazy_mode is not ported yet; it comes with the sparse "
            "slice")
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    m_out = b1 * m + (1 - b1) * g
    v_out = b2 * v + (1 - b2) * torch.square(g)
    return {"ParamOut": p - lr_t * m_out / (torch.sqrt(v_out) + eps),
            "Moment1Out": m_out, "Moment2Out": v_out,
            "Beta1PowOut": (b1p * b1).reshape(1),
            "Beta2PowOut": (b2p * b2).reshape(1)}
