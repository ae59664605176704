"""Tensor layer functions (counterpart of ``sums``, ``fill_constant``,
``fill_constant_batch_size_like`` and ``concat`` in
``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

from ..core.types import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["sums", "fill_constant", "fill_constant_batch_size_like",
           "concat"]


def concat(input, axis=0, name=None):
    from .nn import concat as _concat
    return _concat(input, axis, name)


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A ``value``-filled tensor of ``shape`` whose ``output_dim_idx``
    dim is ``input``'s ``input_dim_idx`` dim at run time."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(
        convert_dtype(dtype), tuple(shape))
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out
