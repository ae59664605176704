"""Control-flow layer functions (counterpart of ``increment`` in
``paddle_tpu/layers/control_flow.py``; the loops and conditionals come
with the slices that use them)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["increment"]


def increment(x, value=1.0, in_place=True):
    """x + value, written back to ``x`` itself when ``in_place`` (the
    optimizers' ``global_step`` counter)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype, x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out
