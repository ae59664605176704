"""Activation ops on the ResNet path (counterpart of ``relu`` in
``paddle_tpu/ops/activation_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("relu")
def _relu(ctx, ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}
