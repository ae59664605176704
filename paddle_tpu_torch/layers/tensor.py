"""Tensor layer functions (counterpart of every layer of
``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

from ..core.types import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_global_var", "cast", "concat", "sums",
           "assign", "fill_constant", "fill_constant_batch_size_like",
           "ones", "zeros", "zeros_like", "reverse", "argmax", "argsort",
           "gather", "scatter", "slice", "shape", "range"]


def create_tensor(dtype, name=None, persistable=False):
    """A variable of ``dtype`` in the current block, with no op."""
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(
        name=name or helper.name, dtype=convert_dtype(dtype),
        persistable=persistable)


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


def assign(input, output=None):
    """A copy of ``input`` (into ``output`` if given)."""
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(
            input.dtype, input.shape)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def reverse(x, axis, name=None):
    """x flipped along ``axis`` (an int or a list)."""
    helper = LayerHelper("reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis if isinstance(axis, (list, tuple))
                            else [axis]})
    return out


def argsort(x, axis=-1, name=None):
    """(sorted x, int64 indices) along ``axis``, ascending and stable."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    ids = helper.create_variable_for_type_inference("int64", x.shape)
    helper.append_op(type="argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def scatter(input, index, updates, overwrite=True, name=None):
    """``input`` with its rows at ``index`` replaced by (or, without
    ``overwrite``, added to) the rows of ``updates``."""
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def shape(input, name=None):
    """``input``'s dims, an int64 vector."""
    helper = LayerHelper("shape", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="shape", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def range(start, end, step, dtype="int64", name=None):
    """[start, end) by ``step``, a vector of ``dtype``."""
    helper = LayerHelper("range", name=name)
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(type="range", outputs={"Out": [out]},
                     attrs={"start": start, "end": end, "step": step,
                            "dtype": convert_dtype(dtype)})
    return out


def slice(input, axes, starts, ends, name=None):
    """Static [start, end) ranges of ``input`` along ``axes``."""
    helper = LayerHelper("slice", name=name)
    shape = list(input.shape) if input.shape else None
    if shape is not None:
        for ax, st, en in zip(axes, starts, ends):
            if shape[ax] is not None and shape[ax] > 0:
                shape[ax] = max(0, min(en, shape[ax]) - st)
            else:
                shape[ax] = en - st
    out = helper.create_variable_for_type_inference(
        input.dtype, tuple(shape) if shape else None)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out
