"""Counterpart of ``copy_len``, the one op of
``paddle_tpu/ops/crf_ops.py`` ported so far (``:273-284``): the linear
chain CRF ops come with the slice that uses them."""
from __future__ import annotations

from ..core.registry import register_op


@register_op("copy_len")
def _copy_len(ctx, ins, attrs):
    """Forward the ``@LEN`` (and nested ``@LEN2``) companions of X to
    Out; no tensor is produced."""
    name_in = ctx.op.inputs["X"][0]
    name_out = ctx.op.outputs["Out"][0]
    lens = ctx.get_len(name_in)
    if lens is not None:
        ctx.set_len(name_out, lens)
    lens2 = ctx.get_len2(name_in)
    if lens2 is not None:
        ctx.set_len2(name_out, lens2)
    return {}


# ---------------------------------------------------------------------------
# Static analysis: copy_len is a metadata marker (it forwards a @LEN
# companion and rebinds no value), so it has nothing to infer and no
# sharding of its own.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import no_outputs  # noqa: E402
from ..analysis.shard_prop import shard_noop  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)

register_shape_fn("copy_len")(no_outputs())
register_shard_fn("copy_len")(shard_noop())
