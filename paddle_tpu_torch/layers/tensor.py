"""Tensor layer functions (counterpart of ``sums`` and ``fill_constant``
in ``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

from ..core.types import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["sums", "fill_constant"]


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(
            input[0].dtype, input[0].shape)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(
            convert_dtype(dtype), tuple(shape))
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": convert_dtype(dtype),
                            "value": float(value)})
    return out
