"""Data-layer functions (counterpart of ``paddle_tpu/layers/io.py``)."""
from __future__ import annotations

from ..core.program import default_main_program
from ..core.types import convert_dtype

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=None, main_program=None, stop_gradient=True):
    """Declare a feed variable.  ``append_batch_size`` prepends -1 like
    the reference; ``lod_level`` > 0 adds one dynamic time dim per level."""
    prog = main_program or default_main_program()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + [-1] * lod_level + shape
    return prog.global_block().create_var(
        name=name, shape=shape, dtype=convert_dtype(dtype),
        lod_level=lod_level, stop_gradient=stop_gradient, is_data=True)
