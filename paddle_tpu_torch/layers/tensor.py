"""Tensor layer functions (counterpart of ``create_global_var``,
``cast``, ``concat``, ``sums``, ``fill_constant``,
``fill_constant_batch_size_like``, ``ones``, ``zeros``, ``argmax`` and
``gather`` in ``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

from ..core.types import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "cast", "sums", "fill_constant",
           "fill_constant_batch_size_like", "concat", "gather", "ones",
           "zeros", "argmax"]


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block var initialized to ``value`` by the startup
    program."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(shape, convert_dtype(dtype),
                                        persistable=persistable, name=name)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def cast(x, dtype):
    from .nn import cast as _cast
    return _cast(x, dtype)


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


def gather(input, index, name=None):
    """Rows of ``input`` at ``index`` (``tensor.py:134``)."""
    helper = LayerHelper("gather", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def argmax(x, axis=0, name=None):
    """The int64 index of the first maximum along ``axis``."""
    helper = LayerHelper("argmax", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="argmax", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out
