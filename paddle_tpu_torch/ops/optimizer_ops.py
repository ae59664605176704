"""Optimizer ops (counterpart of ``sgd`` and ``momentum`` in
``paddle_tpu/ops/optimizer_ops.py``).  As in the JAX package, an update
is an op of the program: it reads the parameter, its gradient and its
accumulators and produces new values, which the executor writes back to
the scope.  Adam and the other optimizers come with the slices that use
them."""
from __future__ import annotations

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
