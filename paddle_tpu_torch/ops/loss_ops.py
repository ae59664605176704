"""Loss ops (counterpart of ``paddle_tpu/ops/loss_ops.py``): only
``mse_loss`` so far, the op of ``layers.square_error_cost``."""
from __future__ import annotations

from ..core.registry import register_op


@register_op("mse_loss")
def _mse_loss(ctx, ins, attrs):
    """Elementwise squared difference (``loss_ops.py:122-125``)."""
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": d * d}
