"""``save`` and ``load`` (counterpart of ``paddle_tpu/ops/io_ops.py``):
registered so that a program holding them loads and runs; they do
nothing when run.  Persistence is the host's work, in
``paddle_tpu_torch/io.py``, as it is in the JAX package's ``io.py``."""
from __future__ import annotations

from ..core.registry import register_op


@register_op("save")
def _save(ctx, ins, attrs):
    return {}


@register_op("load")
def _load(ctx, ins, attrs):
    return {}


from ..analysis.shape_infer import no_outputs  # noqa: E402
from ..analysis.shard_prop import shard_noop  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)

register_shape_fn("save", "load")(no_outputs())
register_shard_fn("save", "load")(shard_noop())
