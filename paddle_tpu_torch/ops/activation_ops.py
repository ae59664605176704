"""Activation ops of the ported paths (counterpart of ``relu``,
``sqrt``, ``sigmoid`` and ``tanh`` in
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


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": torch.sigmoid(ins["X"][0])}


@register_op("tanh")
def _tanh(ctx, ins, attrs):
    return {"Out": torch.tanh(ins["X"][0])}
