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
