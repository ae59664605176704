"""Activation ops (counterpart of ``paddle_tpu/ops/activation_ops.py``:
every op it registers, with its aliases ``softrelu``, ``swish`` and
``softshrink``).

Each computes in its operand's dtype, as the JAX lowerings do (bf16
under AMP); Python constants stay scalars.  ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default) and ``round`` rounds half to
even, as ``jnp.round`` does."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _unary(fn):
    def impl(ctx, ins, attrs):
        return {"Out": fn(ins["X"][0], attrs)}
    return impl


def _simple(fn):
    return _unary(lambda x, attrs: fn(x))


register_op("logsigmoid")(_simple(F.logsigmoid))
register_op("relu6")(_unary(
    lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0))))
register_op("abs")(_simple(torch.abs))
register_op("rsqrt")(_simple(torch.rsqrt))
register_op("round")(_simple(torch.round))
register_op("softsign")(_simple(F.softsign))
register_op("softplus", "softrelu")(_simple(
    lambda x: torch.logaddexp(x, torch.zeros_like(x))))
register_op("sin")(_simple(torch.sin))
register_op("cos")(_simple(torch.cos))
register_op("gelu")(_simple(lambda x: F.gelu(x, approximate="tanh")))
register_op("silu", "swish")(_simple(F.silu))


@register_op("brelu")
def _brelu(ctx, ins, attrs):
    """v1 brelu: clip(x, t_min, t_max)."""
    return {"Out": torch.clamp(ins["X"][0], attrs.get("t_min", 0.0),
                               attrs.get("t_max", 24.0))}


@register_op("leaky_relu")
def _leaky_relu(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": torch.where(x >= 0, x, attrs.get("alpha", 0.02) * x)}


@register_op("elu")
def _elu(ctx, ins, attrs):
    x = ins["X"][0]
    alpha = attrs.get("alpha", 1.0)
    # expm1 of the negative side only, so a large x leaves no inf whose
    # zero cotangent would make a NaN gradient
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return {"Out": torch.where(x > 0, x, alpha * torch.expm1(safe))}


@register_op("stanh")
def _stanh(ctx, ins, attrs):
    """Scaled tanh: b * tanh(a * x)."""
    a = attrs.get("scale_a", 2.0 / 3.0)
    b = attrs.get("scale_b", 1.7159)
    return {"Out": b * torch.tanh(a * ins["X"][0])}


@register_op("hard_shrink")
def _hard_shrink(ctx, ins, attrs):
    x = ins["X"][0]
    t = attrs.get("threshold", 0.5)
    return {"Out": torch.where(x.abs() > t, x, torch.zeros_like(x))}


@register_op("soft_shrink", "softshrink")
def _soft_shrink(ctx, ins, attrs):
    x = ins["X"][0]
    lam = attrs.get("lambda", 0.5)
    return {"Out": torch.where(x > lam, x - lam, torch.where(
        x < -lam, x + lam, torch.zeros_like(x)))}


@register_op("thresholded_relu")
def _thresholded_relu(ctx, ins, attrs):
    x = ins["X"][0]
    t = attrs.get("threshold", 1.0)
    return {"Out": torch.where(x > t, x, torch.zeros_like(x))}


@register_op("hard_sigmoid")
def _hard_sigmoid(ctx, ins, attrs):
    x = ins["X"][0]
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    return {"Out": torch.clamp(x * slope + offset, 0.0, 1.0)}


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    """Learned negative slope: mode all (one alpha), channel (alpha [C]
    over x [N, C, ...]) or element (alpha of x.shape[1:])."""
    x = ins["X"][0]
    alpha = ins["Alpha"][0]
    if alpha.numel() > 1:
        if alpha.dim() == x.dim() - 1:            # element mode
            alpha = alpha.reshape((1,) + tuple(alpha.shape))
        else:                                     # channel mode
            alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": torch.where(x >= 0, x, alpha * x)}


@register_op("relu")
def _relu(ctx, ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}


@register_op("sqrt")
def _sqrt(ctx, ins, attrs):
    return {"Out": torch.sqrt(ins["X"][0])}


# the CTR model's squared error (``benchmark/ctr.py``)
@register_op("square")
def _square(ctx, ins, attrs):
    return {"Out": torch.square(ins["X"][0])}


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": torch.sigmoid(ins["X"][0])}


@register_op("tanh")
def _tanh(ctx, ins, attrs):
    return {"Out": torch.tanh(ins["X"][0])}


# the learning-rate schedules' unary ops (``lr_decay.py``)
@register_op("exp")
def _exp(ctx, ins, attrs):
    return {"Out": torch.exp(ins["X"][0])}


@register_op("log")
def _log(ctx, ins, attrs):
    return {"Out": torch.log(ins["X"][0])}


@register_op("floor")
def _floor(ctx, ins, attrs):
    return {"Out": torch.floor(ins["X"][0])}


@register_op("ceil")
def _ceil(ctx, ins, attrs):
    return {"Out": torch.ceil(ins["X"][0])}


@register_op("reciprocal")
def _reciprocal(ctx, ins, attrs):
    return {"Out": 1.0 / ins["X"][0]}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer): every activation maps
# X -> Out elementwise, so one same_as rule covers the whole file — the
# InferShape analog of activation_op.h's UnaryOpUnchangedInferShape.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import same_as  # noqa: E402
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn(
    "sigmoid", "logsigmoid", "tanh", "relu", "relu6", "abs", "sqrt",
    "rsqrt", "square", "exp", "log", "floor", "ceil", "round",
    "reciprocal", "softsign", "softplus", "softrelu", "sin", "cos",
    "gelu", "silu", "swish", "brelu", "leaky_relu", "elu", "stanh",
    "hard_shrink", "soft_shrink", "softshrink", "thresholded_relu",
    "hard_sigmoid", "prelu",
)(same_as("X"))

# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop): activations are
# elementwise, so outputs carry their input's per-dim sharding unchanged.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import shard_same_as  # noqa: E402
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn(
    "sigmoid", "logsigmoid", "tanh", "relu", "relu6", "abs", "sqrt",
    "rsqrt", "square", "exp", "log", "floor", "ceil", "round",
    "reciprocal", "softsign", "softplus", "softrelu", "sin", "cos",
    "gelu", "silu", "swish", "brelu", "leaky_relu", "elu", "stanh",
    "hard_shrink", "soft_shrink", "softshrink", "thresholded_relu",
    "hard_sigmoid", "prelu",
)(shard_same_as("X"))
