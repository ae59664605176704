"""Activation ops of the ResNet paths (counterpart of ``relu`` and
``sqrt`` in ``paddle_tpu/ops/activation_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("relu")
def _relu(ctx, ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}


@register_op("sqrt")
def _sqrt(ctx, ins, attrs):
    return {"Out": torch.sqrt(ins["X"][0])}
