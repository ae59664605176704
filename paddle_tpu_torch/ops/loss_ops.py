"""Loss ops (counterpart of ``paddle_tpu/ops/loss_ops.py``): only
``mse_loss`` so far, the op of ``layers.square_error_cost``."""
from __future__ import annotations

from ..core.registry import register_op


@register_op("mse_loss")
def _mse_loss(ctx, ins, attrs):
    """Elementwise squared difference (``loss_ops.py:122-125``)."""
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": d * d}


# ---------------------------------------------------------------------------
# Static shape rule and sharding rule: mse_loss is elementwise on X.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import same_as  # noqa: E402
from ..analysis.shard_prop import shard_same_as  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)

register_shape_fn("mse_loss")(same_as("X"))
register_shard_fn("mse_loss")(shard_same_as("X"))
