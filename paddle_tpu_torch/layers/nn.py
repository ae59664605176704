"""NN layer functions building program ops (counterpart of
``paddle_tpu/layers/nn.py``).  Each function appends the same op types
with the same attrs as its JAX twin, so both packages build the same
program.  Only the layers the ResNet serving and training paths, the
gradient clips, the attention slice, the seq2seq slice and the model
zoo (``models/``, ``nets``) and the learning-rate schedules
(``lr_decay.py``) use are ported."""
from __future__ import annotations

from ..core import unique_name
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "conv2d", "pool2d", "batch_norm", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "scale", "mean",
           "cross_entropy", "clip", "clip_by_norm", "softmax", "matmul",
           "dropout", "square_error_cost", "flash_attention", "embedding",
           "dynamic_gru", "gru_unit", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "reshape", "squeeze", "unsqueeze", "concat",
           "lrn", "dynamic_lstm", "sequence_conv", "split", "cast",
           "autoincreased_step_counter"]


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _conv_out(size, k, p, s, d=1):
    if size is None or size < 0:
        return -1
    ke = d * (k - 1) + 1
    return (size + 2 * p - ke) // s + 1


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected: mul + sum + bias + act.  A list of inputs (with
    one ``param_attr`` each, or one for all) is projected input by input
    and summed.  A sequence input flattened at ``num_flatten_dims`` >= 2
    keeps its lod level, and its ``@LEN`` is copied to the output."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    attrs = param_attr if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(inputs)
    mul_results = []
    for inp, pa in zip(inputs, attrs):
        in_dim = 1
        for s in inp.shape[num_flatten_dims:]:
            in_dim *= s
        w = helper.create_parameter(pa, shape=[in_dim, size],
                                    dtype=inp.dtype)
        out_shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(
            inp.dtype, out_shape,
            lod_level=inp.lod_level if num_flatten_dims >= 2 else 0)
        helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_results[0].dtype, mul_results[0].shape,
            lod_level=mul_results[0].lod_level)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias)
    out = helper.append_activation(pre_act)
    if out.lod_level and inputs[0].lod_level:
        _copy_len(helper, inputs[0], out)
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None,
              sparse=False):
    """Lookup of the rows of a [V, D] table (``layers/nn.py:96-150``).
    ``is_sparse`` is recorded as the op's attr, as the JAX layer does;
    the gradient is dense either way.

    ``sparse=True`` declares a **host-resident** table instead
    (``paddle_tpu_torch.sparse``): no parameter is created; the op is
    ``lookup_table_sparse``, whose ``<table>@ROWS`` [bucket, D] and
    ``<table>@RIDX`` feeds a ``SparseSession`` injects each batch, and
    the table's optimizer update runs on the host when the session
    pushes the rows' gradient.  The table is named ``name`` (or a
    generated unique name); ``sparse.table_specs(program)`` lists a
    program's tables.  ``padding_idx`` is refused with ``sparse=True``
    (reserve a vocab id for padding instead)."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    in_shape = input.shape or (-1, 1)
    if in_shape and in_shape[-1] == 1:
        out_shape = tuple(in_shape[:-1]) + (size[1],)
    else:
        out_shape = tuple(in_shape) + (size[1],)
    out = helper.create_variable_for_type_inference(
        dtype, out_shape, lod_level=input.lod_level)
    if sparse:
        return _sparse_embedding(helper, input, size, padding_idx, dtype,
                                 name, out, out_shape)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    helper.append_op(type="lookup_table",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "padding_idx": -1 if padding_idx is None
                            else padding_idx})
    if input.lod_level:
        _copy_len(helper, input, out)
    return out


def _sparse_embedding(helper, input, size, padding_idx, dtype, name, out,
                      out_shape):
    if padding_idx is not None:
        raise ValueError(
            "embedding(sparse=True) does not support padding_idx: the host "
            "table has no zero-row convention; reserve a vocab id for "
            "padding instead")
    table_name = name or unique_name.generate("sparse_table")
    block = helper.block
    rows_name = table_name + "@ROWS"
    if block.has_var(rows_name):
        raise ValueError(
            f"embedding(sparse=True): a sparse table named {table_name!r} "
            f"already exists in this program; one embedding site per "
            f"table (share its output instead)")
    rows = block.create_var(name=rows_name, shape=(-1, size[1]),
                            dtype=dtype, is_data=True, session_feed=True)
    rows.is_sparse_rows = True
    inv = block.create_var(name=table_name + "@RIDX",
                           shape=out_shape[:-1], dtype="int32",
                           is_data=True, session_feed=True)
    helper.append_op(type="lookup_table_sparse",
                     inputs={"Rows": [rows], "Ids": [input],
                             "Inverse": [inv]},
                     outputs={"Out": [out]},
                     attrs={"table_name": table_name,
                            "vocab_size": int(size[0]),
                            "dim": int(size[1]), "dtype": str(dtype)})
    if input.lod_level:
        _copy_len(helper, input, out)
    return out


def _copy_len(helper, src, dst):
    """Append the op that hands ``src``'s ``@LEN`` (and ``@LEN2``) to
    ``dst``."""
    helper.append_op(type="copy_len", inputs={"X": [src]},
                     outputs={"Out": [dst]}, attrs={})


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """The LSTM recurrence over a pre-projected [B, T, size] sequence
    (size = 4 H, ``layers/nn.py:170``); returns (hidden, cell), each
    [B, T, H] with the input's lengths.  The bias holds the peephole
    weights as a 3 H tail when ``use_peepholes``."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    hidden = size // 4
    w = helper.create_parameter(param_attr, shape=[hidden, 4 * hidden],
                                dtype=dtype)
    bias_size = 4 * hidden + (3 * hidden if use_peepholes else 0)
    b = helper.create_parameter(
        ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=[1, bias_size],
        dtype=dtype, is_bias=True)
    B, T = (input.shape or (-1, -1))[:2]
    hid = helper.create_variable_for_type_inference(
        dtype, (B, T, hidden), lod_level=input.lod_level)
    cell = helper.create_variable_for_type_inference(
        dtype, (B, T, hidden), lod_level=input.lod_level)
    ins = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    helper.append_op(type="lstm", inputs=ins,
                     outputs={"Hidden": [hid], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hid, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None):
    """The GRU recurrence over a pre-projected [B, T, 3 size] sequence;
    Hidden [B, T, size] carries the input's lengths."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(
        ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=[1, 3 * size],
        dtype=dtype, is_bias=True)
    B, T = (input.shape or (-1, -1))[:2]
    hid = helper.create_variable_for_type_inference(
        dtype, (B, T, size), lod_level=input.lod_level)
    ins = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    helper.append_op(type="gru", inputs=ins, outputs={"Hidden": [hid]},
                     attrs={"gate_activation": gate_activation,
                            "is_reverse": is_reverse,
                            "activation": candidate_activation})
    return hid


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """One GRU step from gates [B, size] (size = 3 H) and the previous
    hidden [B, H]; returns (hidden, reset hidden, gates)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = input.dtype
    h = size // 3
    w = helper.create_parameter(param_attr, shape=[h, size], dtype=dtype)
    b = helper.create_parameter(
        ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=[1, size],
        dtype=dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype,
                                                    (hidden.shape[0], h))
    gate = helper.create_variable_for_type_inference(dtype)
    reset = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gru_unit",
                     inputs={"Input": [input], "HiddenPrev": [hidden],
                             "Weight": [w], "Bias": [b]},
                     outputs={"Hidden": [out], "Gate": [gate],
                              "ResetHiddenPrev": [reset]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return out, reset, gate


def sequence_pool(input, pool_type, name=None):
    """Pool each sequence over time (average, sum, sqrt, max, last,
    first); a nested sequence collapses both sequence dims."""
    helper = LayerHelper("sequence_pool", name=name)
    if input.shape is None:
        shape = None
    elif input.lod_level >= 2:
        shape = (input.shape[0],) + tuple(input.shape[3:])
    else:
        shape = (input.shape[0],) + tuple(input.shape[2:])
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, name=None):
    return sequence_pool(input, "first", name=name)


def sequence_last_step(input, name=None):
    return sequence_pool(input, "last", name=name)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    """A context window of ``filter_size`` steps, centred, projected to
    ``num_filters`` (``layers/nn.py:1025``); bias and activation after."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    d = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(
        dtype, tuple(input.shape[:-1]) + (num_filters,),
        lod_level=input.lod_level)
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]},
                     attrs={"contextStride": filter_stride,
                            "contextStart": -(filter_size // 2),
                            "contextLength": filter_size})
    pre_act = helper.append_bias_op(out)
    return helper.append_activation(pre_act)


def concat(input, axis=0, name=None):
    """Join ``input`` along ``axis`` (``layers/nn.py:527``).  A
    feature-axis concat of sequences is still a sequence: it keeps the
    LoD level and takes the first sequence input's ``@LEN``."""
    helper = LayerHelper("concat", name=name)
    shape = list(input[0].shape) if input[0].shape else None
    if shape is not None:
        tot = 0
        for v in input:
            if v.shape is None or v.shape[axis] < 0:
                tot = -1
                break
            tot += v.shape[axis]
        shape[axis] = tot
    lod = max(getattr(v, "lod_level", 0) for v in input)
    out = helper.create_variable_for_type_inference(
        input[0].dtype, tuple(shape) if shape else None,
        lod_level=lod if axis != 0 else 0)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    if out.lod_level:
        _copy_len(helper, next(v for v in input
                               if getattr(v, "lod_level", 0)), out)
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    """Reshape to ``shape`` (0 copies the input's dim, one -1 is
    inferred).  ``actual_shape`` and ``inplace`` are accepted and
    unused, as in the JAX layer."""
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, tuple(
        s if s != 0 else x.shape[i] for i, s in enumerate(shape)))
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections`` equal parts of ``input`` along ``dim``, or
    parts of the listed sizes (``layers/nn.py:659``)."""
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    shape = None
    if input.shape is not None:
        ax = {a % len(input.shape) for a in axes}
        shape = tuple(s for i, s in enumerate(input.shape) if i not in ax)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    shape = None
    if input.shape is not None:
        shape = list(input.shape)
        for a in sorted(axes):
            shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
        shape = tuple(shape)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None, use_pallas=None):
    """2-D convolution, NCHW.  ``use_pallas``: tri-state per-layer
    override of the ``conv1x1_pallas`` routing (True forces the
    hand-written 1x1 kernel on eligible shapes, False pins this layer to
    the plain convolution, None defers to the executor/flag); the attr
    keeps the JAX package's name so programs match."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    fs = _pair(filter_size)
    st = _pair(stride)
    pd = _pair(padding)
    dl = _pair(dilation)
    n, c = input.shape[0], input.shape[1]
    w = helper.create_parameter(
        param_attr, shape=[num_filters, c // groups, fs[0], fs[1]], dtype=dtype)
    oh = _conv_out(input.shape[2], fs[0], pd[0], st[0], dl[0])
    ow = _conv_out(input.shape[3], fs[1], pd[1], st[1], dl[1])
    out = helper.create_variable_for_type_inference(
        dtype, (n, num_filters, oh, ow))
    conv_attrs = {"strides": st, "paddings": pd, "dilations": dl,
                  "groups": groups}
    if use_pallas is not None:
        conv_attrs["use_pallas"] = bool(use_pallas)
    helper.append_op(type="conv2d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs=conv_attrs)
    if helper.kwargs.get("bias_attr") is not False:
        b = helper.create_parameter(
            ParamAttr._to_attr(bias_attr) or ParamAttr(),
            shape=[num_filters], dtype=dtype, is_bias=True)
        out2 = helper.create_variable_for_type_inference(dtype, out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [out2]}, attrs={"axis": 1})
        out = out2
    return helper.append_activation(out)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    ks = _pair(pool_size)
    st = _pair(pool_stride)
    pd = _pair(pool_padding)
    n, c, h, w = input.shape

    def _out(size, k, p, s):
        if size is None or size < 0:
            return -1
        if ceil_mode:
            return -(-(size + 2 * p - k) // s) + 1
        return (size + 2 * p - k) // s + 1

    if global_pooling:
        oh = ow = 1
    else:
        oh = _out(h, ks[0], pd[0], st[0])
        ow = _out(w, ks[1], pd[1], st[1])
    out = helper.create_variable_for_type_inference(
        input.dtype, (n, c, oh, ow))
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": ks,
                            "strides": st, "paddings": pd,
                            "global_pooling": global_pooling,
                            "exclusive": exclusive,
                            "ceil_mode": ceil_mode})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None, name=None,
               use_global_stats=None):
    """Batch normalization; the running stats are persistable vars that
    the op's MeanOut/VarianceOut write."""
    helper = LayerHelper("batch_norm", name=name)
    dtype = input.dtype
    c = input.shape[1]
    scale = helper.create_parameter(
        ParamAttr._to_attr(param_attr) or ParamAttr(), shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=[c], dtype=dtype,
        is_bias=True)
    mean = helper.create_global_variable([c], dtype, name=moving_mean_name)
    var = helper.create_global_variable([c], dtype, name=moving_variance_name)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    helper.set_variable_initializer(var, ConstantInitializer(1.0))
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype, input.shape)
    helper.append_op(type="batch_norm",
                     inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                             "Mean": [mean], "Variance": [var]},
                     outputs={"Y": [out], "MeanOut": [mean.name],
                              "VarianceOut": [var.name],
                              "SavedMean": [saved_mean],
                              "SavedVariance": [saved_var]},
                     attrs={"momentum": momentum, "epsilon": epsilon,
                            "is_test": is_test,
                            "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def _elementwise_layer(op, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, x.shape, lod_level=max(x.lod_level, getattr(y, "lod_level", 0)))
    helper.append_op(type=op, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    final = helper.append_activation(out, act)
    if final.lod_level:
        _copy_len(helper, x if x.lod_level else y, final)
    return final


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_min", x, y, axis, act, name)


def _unary_layer(op_type, x, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, x.shape, lod_level=x.lod_level)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs or {})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = _unary_layer("scale", x, {"scale": float(scale), "bias": float(bias),
                                    "bias_after_scale": bias_after_scale},
                       name)
    if act:
        return LayerHelper("scale_act").append_activation(out, act)
    return out


def clip(x, min, max, name=None):
    return _unary_layer("clip", x, {"min": float(min), "max": float(max)}, name)


def clip_by_norm(x, max_norm, name=None):
    return _unary_layer("clip_by_norm", x, {"max_norm": float(max_norm)}, name)


def mean(x, name=None):
    """Mean of every element: a scalar (the loss average)."""
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, ())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False, name=None):
    """-log(probability of the label) per row, [N, 1]; ``input`` holds
    probabilities (a softmax output)."""
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], 1) if input.shape else None)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]}, attrs={"soft_label": soft_label})
    return out


def softmax(input, axis=-1, use_cudnn=True, name=None):
    return _unary_layer("softmax", input, {"axis": axis}, name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    """Batched matrix product with optional transposes of the last two
    dims (``layers/nn.py:679``)."""
    helper = LayerHelper("matmul", name=name)
    shape = None
    if x.shape is not None and y.shape is not None \
            and len(x.shape) >= 2 and len(y.shape) >= 2:
        xs = x.shape[:-2] + (x.shape[-1], x.shape[-2]) if transpose_x \
            else x.shape
        ys = y.shape[:-2] + (y.shape[-1], y.shape[-2]) if transpose_y \
            else y.shape
        batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
        shape = tuple(batch) + (xs[-2], ys[-1])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape,
                                                    lod_level=x.lod_level)
    mask = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed or 0,
                            "dropout_implementation": dropout_implementation})
    return out


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization across channels
    (``layers/nn.py:979``)."""
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def cast(x, dtype):
    from ..core.types import convert_dtype
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(
        convert_dtype(dtype), x.shape, lod_level=x.lod_level)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": convert_dtype(dtype)})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter (``@STEP_COUNTER@`` by default),
    initialized to ``begin - step`` and advanced by ``step`` by an
    ``increment`` op at each run of the program; a second call returns
    the same counter."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    gb = helper.main_program.global_block()
    if name in gb.vars:
        return gb.vars[name]
    counter = helper.create_global_variable([1], "int64", name=name)
    helper.set_variable_initializer(
        counter, ConstantInitializer(begin - step))
    helper.append_op(type="increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]}, attrs={"step": float(step)})
    return counter


def square_error_cost(input, label, name=None):
    """Elementwise squared error, the ``mse_loss`` op."""
    helper = LayerHelper("mse_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="mse_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]}, attrs={})
    return out


def flash_attention(q, k, v, causal=False, block_q=None, block_k=None,
                    sequence_parallel=True, interpret=False, name=None):
    """Fused O(T)-memory attention on the hand-written CUDA kernels
    (``ops/flash_attention.py``).  q/k/v: [B, T, H, D] or [BH, T, D].

    ``block_q``/``block_k`` default to 1024 x 1024, the JAX layer's
    default with autotuning off; they are the TPU tile sizes and here
    decide only the plain route for ragged lengths.
    ``sequence_parallel`` and ``interpret`` are recorded as op attrs, as
    the JAX layer does, and ignored by the port's op.

    With the ``autotune`` flag on and a persisted ``cuda/flash_attention``
    record for this card, the record's ring depths become the op's
    ``fwd_stages``/``bwd_stages`` attrs, resolved here at build time so
    the program's content digest (and each captured step's key) sees
    them.  With no record, or the flag off, the op has no such attrs and
    the kernels take their plans' own depths."""
    block_q = 1024 if block_q is None else block_q
    block_k = 1024 if block_k is None else block_k
    from ..core.registry import resolve_tuned
    default = {"fwd_stages": None, "bwd_stages": None}
    stages = resolve_tuned("cuda/flash_attention", default)
    helper = LayerHelper("flash_attention", name=name)
    out_shape = tuple(q.shape[:-1]) + (v.shape[-1],)
    out = helper.create_variable_for_type_inference(q.dtype, out_shape)
    attrs = {"causal": causal, "block_q": block_q, "block_k": block_k,
             "sequence_parallel": sequence_parallel,
             "interpret": interpret}
    if stages is not default:
        attrs.update(stages)
    helper.append_op(type="flash_attention",
                     inputs={"Q": [q], "K": [k], "V": [v]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out
