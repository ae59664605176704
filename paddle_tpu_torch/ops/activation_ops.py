"""Activation ops of the ported paths (counterpart of ``relu``,
``sqrt``, ``square``, ``sigmoid``, ``tanh``, ``exp``, ``log``,
``floor``, ``ceil`` and ``reciprocal`` in
``paddle_tpu/ops/activation_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


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
    "sigmoid", "tanh", "relu", "sqrt", "square", "exp", "log", "floor",
    "ceil", "reciprocal",
)(same_as("X"))

# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop): activations are
# elementwise, so outputs carry their input's per-dim sharding unchanged.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import shard_same_as  # noqa: E402
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn(
    "sigmoid", "tanh", "relu", "sqrt", "square", "exp", "log", "floor",
    "ceil", "reciprocal",
)(shard_same_as("X"))
