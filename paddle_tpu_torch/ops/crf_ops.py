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
