"""NN layer functions building program ops (counterpart of
``paddle_tpu/layers/nn.py``).  Each function appends the same op types
with the same attrs as its JAX twin, so both packages build the same
program.  Ported: the layers of the ResNet serving and training paths,
the gradient clips, the attention slice, the seq2seq slice, the model
zoo (``models/``, ``nets``), the learning-rate schedules
(``lr_decay.py``), the dense layers over the activation, nn, loss,
metric, index and reduction ops (classification heads, ``layer_norm``,
the losses, ``accuracy``/``auc``, ``topk``, ``one_hot``, ``transpose``,
``reduce_*``, the 3-D and transposed convolutions, pooling variants),
and the layers over the tensor and math ops (``crop``, ``pad``,
``expand``, ``multiplex``, ``sampling_id``, ``elementwise_pow``,
``l2_normalize``, and the v1 attention and CTR layers ``conv_shift``,
``interpolation``, ``outer_prod``, ``factorization_machine``,
``scale_sub_region``), and the layers over the sequence, CRF and
embedding ops (the ``sequence_*`` layers, ``lod_reset``, ``row_conv``,
``lstm_unit``, ``kmax_sequence_score``, ``nce``, ``hsigmoid``,
``linear_chain_crf``, ``crf_decoding``, ``warpctc``)."""
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
           "autoincreased_step_counter", "conv2d_transpose", "layer_norm",
           "softmax_with_cross_entropy", "topk", "maxout", "im2sequence",
           "one_hot", "reduce_sum", "reduce_mean", "reduce_max",
           "reduce_min", "reduce_prod", "mul", "cos_sim", "accuracy", "auc",
           "sigmoid_cross_entropy_with_logits", "transpose", "relu",
           "smooth_l1", "bilinear_interp", "label_smooth", "conv3d",
           "pool3d", "spp", "prelu", "log_loss", "hinge_loss", "huber_loss",
           "rank_loss", "lambda_rank", "margin_rank_loss",
           "squared_l2_distance", "squared_l2_norm", "kldiv_loss",
           "modified_huber_loss", "bilinear_tensor_product", "crop", "pad",
           "expand", "multiplex", "sampling_id", "elementwise_pow",
           "l2_normalize", "conv_shift", "interpolation", "outer_prod",
           "factorization_machine", "scale_sub_region", "lstm_unit",
           "sequence_softmax", "sequence_expand", "sequence_concat",
           "sequence_reshape", "sequence_slice", "sequence_reverse",
           "lod_reset", "row_conv", "kmax_sequence_score", "nce", "hsigmoid",
           "linear_chain_crf", "crf_decoding", "warpctc", "roi_pool",
           "moe"]


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _conv_out(size, k, p, s, d=1):
    if size is None or size < 0:
        return -1
    ke = d * (k - 1) + 1
    return (size + 2 * p - ke) // s + 1


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None, use_mkldnn=False):
    """Fully connected: mul + sum + bias + act (``use_mkldnn``, the
    reference's CPU-library switch, is accepted and ignored, as in the
    JAX package).  A list of inputs (with
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


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_pow", x, y, axis, act, name)


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



# ---------------------------------------------------------------------------
# The dense layers (``layers/nn.py`` of the JAX package, each in its order
# of parameter and variable creation)
# ---------------------------------------------------------------------------
def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v, v]


def _prod(t):
    p = 1
    for x in t:
        p *= x
    return p


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """Transposed 2-D convolution (``layers/nn.py:311``): Filter [C_in,
    num_filters, kh, kw], from ``filter_size`` or solved from
    ``output_size``; one group."""
    if groups not in (None, 1):
        raise NotImplementedError(
            "conv2d_transpose groups>1: no reference demo uses it; "
            "split channels + concat as a workaround")
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    st = _pair(stride)
    pd = _pair(padding)
    dl = _pair(dilation)
    n, c, h, ww = input.shape
    if filter_size is None:
        os = _pair(output_size)
        fs = [os[0] + 2 * pd[0] - (h - 1) * st[0],
              os[1] + 2 * pd[1] - (ww - 1) * st[1]]
    else:
        fs = _pair(filter_size)
    w = helper.create_parameter(
        param_attr, shape=[c, num_filters, fs[0], fs[1]], dtype=dtype)
    oh = (h - 1) * st[0] - 2 * pd[0] + dl[0] * (fs[0] - 1) + 1 \
        if h > 0 else -1
    ow = (ww - 1) * st[1] - 2 * pd[1] + dl[1] * (fs[1] - 1) + 1 \
        if ww > 0 else -1
    out = helper.create_variable_for_type_inference(
        dtype, (n, num_filters, oh, ow))
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": st, "paddings": pd, "dilations": dl})
    if helper.kwargs.get("bias_attr") is not False and bias_attr is not False:
        out2 = helper.create_variable_for_type_inference(dtype, out.shape)
        b = helper.create_parameter(
            ParamAttr._to_attr(bias_attr) or ParamAttr(),
            shape=[num_filters], dtype=dtype, is_bias=True)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [out2]}, attrs={"axis": 1})
        out = out2
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """Layer normalization over the dims from ``begin_norm_axis`` on,
    with a learned Scale (ones) and Bias (zeros) over their product."""
    helper = LayerHelper("layer_norm", name=name)
    dtype = input.dtype
    norm_shape = [int(_prod(input.shape[begin_norm_axis:]))]
    ins = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            ParamAttr._to_attr(param_attr) or ParamAttr(), shape=norm_shape,
            dtype=dtype, default_initializer=ConstantInitializer(1.0))
        ins["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=norm_shape,
            dtype=dtype, is_bias=True)
        ins["Bias"] = [b]
    out = helper.create_variable_for_type_inference(dtype, input.shape)
    mean = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="layer_norm", inputs=ins,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out, act)


def relu(x, name=None):
    return _unary_layer("relu", x, None, name)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    shape = tuple(x.shape[p] for p in perm) if x.shape else None
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def _reduce_layer(op, input, dim, keep_dim, name):
    helper = LayerHelper(op, name=name)
    shape = None
    if dim is not None and input.shape is not None:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        nd = len(input.shape)
        dropped = {d % nd for d in dims}
        shape = tuple(1 if i in dropped else s
                      for i, s in enumerate(input.shape)) if keep_dim else \
            tuple(s for i, s in enumerate(input.shape) if i not in dropped)
    elif dim is None:
        # reduce_all: a 0-d result (keep_dim keeps the rank as all ones)
        if not keep_dim:
            shape = ()
        elif input.shape is not None:
            shape = tuple(1 for _ in input.shape)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    helper.append_op(type=op, inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", input, dim, keep_dim, name)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


# -- losses / classification -------------------------------------------------
def softmax_with_cross_entropy(logits, label, soft_label=False, name=None):
    """The fused, stable logits -> loss [N, 1] (its Softmax output is
    made too and not returned, as in the JAX layer)."""
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_variable_for_type_inference(
        logits.dtype, logits.shape)
    loss = helper.create_variable_for_type_inference(
        logits.dtype, (logits.shape[0], 1) if logits.shape else None)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None,
              name=None):
    helper = LayerHelper("smooth_l1_loss", name=name)
    diff = helper.create_variable_for_type_inference(x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        ins["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        ins["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=ins,
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": sigma or 1.0})
    return out


def _binary_loss_layer(op_type, x, y, x_slot="X", y_slot="Y", attrs=None,
                       out_slot="Out", name=None, shape=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, shape if shape is not None else x.shape)
    helper.append_op(type=op_type, inputs={x_slot: [x], y_slot: [y]},
                     outputs={out_slot: [out]}, attrs=attrs or {})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    """-label log(p + eps) - (1 - label) log(1 - p + eps)."""
    return _binary_loss_layer("log_loss", input, label, "Predicted", "Labels",
                              {"epsilon": epsilon}, "Loss", name)


def hinge_loss(input, label, name=None):
    return _binary_loss_layer("hinge_loss", input, label, "Logits", "Labels",
                              out_slot="Loss", name=name)


def huber_loss(input, label, delta=1.0, name=None):
    return _binary_loss_layer("huber_loss", input, label, "X", "Y",
                              {"delta": delta}, "Out", name)


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype, left.shape)
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={"Out": [out]}, attrs={})
    return out


def lambda_rank(score, label, ndcg_num=5, max_sort_size=-1, name=None):
    """Listwise LambdaRank (v1 lambda_cost) over padded query groups
    (``layers/nn.py:843``): score and label are lod_level-1 sequences
    [B, M(, 1)] with an ``@LEN`` a group.  Returns NDCG@ndcg_num [B, 1],
    whose gradient with respect to score is the lambda direction."""
    helper = LayerHelper("lambda_rank", name=name)
    out = helper.create_variable_for_type_inference(
        "float32", (score.shape[0], 1))
    helper.append_op(type="lambda_rank",
                     inputs={"Score": [score], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ndcg_num": ndcg_num,
                            "max_sort_size": max_sort_size})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype, left.shape)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label], "X1": [left], "X2": [right]},
                     outputs={"Out": [out]}, attrs={"margin": margin})
    return out


def squared_l2_distance(x, y, name=None):
    shape = (x.shape[0], 1) if x.shape else None
    return _binary_loss_layer("squared_l2_distance", x, y, "X", "Y",
                              out_slot="Out", name=name, shape=shape)


def squared_l2_norm(x, name=None):
    return _unary_layer("squared_l2_norm", x, name=name)


def kldiv_loss(x, target, reduction="mean", name=None):
    return _binary_loss_layer("kldiv_loss", x, target, "X", "Target",
                              {"reduction": reduction}, "Loss", name)


def modified_huber_loss(input, label, name=None):
    return _binary_loss_layer("modified_huber_loss", input, label, "X", "Y",
                              out_slot="Out", name=name)


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    """out_k = x W_k y^T + b, W [size, dx, dy]."""
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dx, dy = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(param_attr, shape=[size, dx, dy],
                                dtype=x.dtype)
    out = helper.create_variable_for_type_inference(
        x.dtype, (x.shape[0], size))
    ins = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        b = helper.create_parameter(
            ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=[1, size],
            dtype=x.dtype, is_bias=True)
        ins["Bias"] = [b]
    helper.append_op(type="bilinear_tensor_product", inputs=ins,
                     outputs={"Out": [out]}, attrs={})
    return helper.append_activation(out)


def cos_sim(X, Y, name=None):
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """fluid's accuracy layer: ``topk`` of ``input``, then the accuracy
    op against ``label`` (Correct and Total int32, into ``correct`` and
    ``total`` when given)."""
    helper = LayerHelper("accuracy", name=name)
    topk_out, topk_indices = topk(input, k)
    acc_out = helper.create_variable_for_type_inference("float32", (1,))
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=200, name=None):
    helper = LayerHelper("auc", name=name)
    auc_out = helper.create_variable_for_type_inference("float32", (1,))
    stat_pos = helper.create_variable_for_type_inference("float32")
    stat_neg = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="auc",
                     inputs={"Predict": [input], "Label": [label]},
                     outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                              "StatNegOut": [stat_neg]},
                     attrs={"num_thresholds": num_thresholds})
    return auc_out


def topk(input, k, name=None):
    """(values, int64 indices) of the k largest along the last dim."""
    helper = LayerHelper("top_k", name=name)
    shape = tuple(input.shape[:-1]) + (k,) if input.shape else None
    values = helper.create_variable_for_type_inference(input.dtype, shape)
    indices = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """(1 - epsilon) label + epsilon / n, one ``scale`` op (a uniform
    prior; ``prior_dist`` is accepted and, as in the JAX layer, unused)."""
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype, label.shape)
    n = label.shape[-1]
    helper.append_op(type="scale", inputs={"X": [label]},
                     outputs={"Out": [out]},
                     attrs={"scale": 1.0 - epsilon, "bias": epsilon / n})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    n, c, h, w = x.shape
    out = helper.create_variable_for_type_inference(
        x.dtype, (n, c // groups, h, w))
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def bilinear_interp(input, out_h, out_w, name=None):
    helper = LayerHelper("bilinear_interp", name=name)
    n, c = input.shape[0], input.shape[1]
    out = helper.create_variable_for_type_inference(
        input.dtype, (n, c, out_h, out_w))
    helper.append_op(type="bilinear_interp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"out_h": out_h, "out_w": out_w})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """Image patches as a sequence (lod_level 1), one step a patch."""
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, lod_level=1)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": _pair(filter_size),
                            "strides": _pair(stride),
                            "paddings": _pair(padding)})
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    """3-D convolution, NCDHW."""
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    fs, st, pd, dl = (_triple(filter_size), _triple(stride),
                      _triple(padding), _triple(dilation))
    n, c = input.shape[0], input.shape[1]
    w = helper.create_parameter(
        param_attr, shape=[num_filters, c // groups] + fs, dtype=dtype)
    dims = [_conv_out(input.shape[2 + i], fs[i], pd[i], st[i], dl[i])
            for i in range(3)]
    out = helper.create_variable_for_type_inference(
        dtype, (n, num_filters) + tuple(dims))
    helper.append_op(type="conv3d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": st, "paddings": pd, "dilations": dl,
                            "groups": groups})
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


def pool3d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, name=None):
    """3-D pooling, NCDHW (strides default to the window)."""
    helper = LayerHelper("pool3d", name=name)
    ks = _triple(pool_size)
    st = _triple(pool_stride if pool_stride is not None else pool_size)
    pd = _triple(pool_padding)
    n, c = input.shape[0], input.shape[1]
    if global_pooling:
        dims = (1, 1, 1)
    else:
        dims = tuple(_conv_out(input.shape[2 + i], ks[i], pd[i], st[i])
                     for i in range(3))
    out = helper.create_variable_for_type_inference(
        input.dtype, (n, c) + dims)
    helper.append_op(type="pool3d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": ks,
                            "strides": st, "paddings": pd,
                            "global_pooling": global_pooling})
    return out


def spp(input, pyramid_height=3, pool_type="max", name=None):
    """Spatial pyramid pooling: the concat of 4**level bins a level."""
    helper = LayerHelper("spp", name=name)
    n, c = input.shape[0], input.shape[1]
    bins = sum(4 ** lv for lv in range(pyramid_height))
    out = helper.create_variable_for_type_inference(
        input.dtype, (n, c * bins))
    helper.append_op(type="spp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pyramid_height": pyramid_height,
                            "pooling_type": pool_type})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """Learned negative slope, mode all/channel/element; alpha starts at
    0.25."""
    from .. import initializer
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        param_attr if param_attr is not None else
        ParamAttr(initializer=initializer.Constant(0.25)),
        shape=alpha_shape, dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x over its L2 norm along ``axis`` (floored at ``epsilon``)."""
    return _unary_layer("l2_normalize", x,
                        {"axis": axis, "epsilon": epsilon}, name)


def pad(x, paddings, pad_value=0.0, name=None):
    """Constant padding, ``paddings`` = [before0, after0, before1, ...]."""
    return _unary_layer("pad", x, {"paddings": list(paddings),
                                   "pad_value": float(pad_value)}, name)


def expand(x, expand_times, name=None):
    """Each dim tiled ``expand_times`` times."""
    helper = LayerHelper("expand", name=name)
    shape = None
    if x.shape is not None:
        shape = tuple(s * t if s is not None and s >= 0 else s
                      for s, t in zip(x.shape, expand_times))
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def multiplex(inputs, index, name=None):
    """Row i of candidate ``index[i]`` among ``inputs``."""
    helper = LayerHelper("multiplex", name=name)
    out = helper.create_variable_for_type_inference(
        inputs[0].dtype, inputs[0].shape)
    helper.append_op(type="multiplex",
                     inputs={"X": list(inputs), "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def crop(x, shape, offsets=None, name=None):
    """The window of ``shape`` at static ``offsets`` (a -1 in ``shape``
    keeps the axis to its end)."""
    helper = LayerHelper("crop", name=name)
    offsets = offsets or [0] * len(shape)
    out = helper.create_variable_for_type_inference(x.dtype, tuple(shape))
    helper.append_op(type="crop", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "offsets": list(offsets)})
    return out


def sampling_id(x, name=None):
    """One int64 id a row, drawn from the row's probabilities."""
    helper = LayerHelper("sampling_id", name=name)
    out = helper.create_variable_for_type_inference(
        "int64", (x.shape[0],))
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def conv_shift(x, y, name=None):
    """Circular correlation (NTM attention shift): X [B, M], Y [B, N
    odd]."""
    helper = LayerHelper("conv_shift", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="conv_shift", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def interpolation(w, x, y, name=None):
    """w * x + (1 - w) * y with a weight a row, w [B, 1]."""
    helper = LayerHelper("interpolation", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="interpolation",
                     inputs={"W": [w], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def outer_prod(x, y, name=None):
    """Each row's outer product, flattened to [B, M * N]."""
    helper = LayerHelper("outer_prod", name=name)
    shape = None
    if x.shape and y.shape and x.shape[1] > 0 and y.shape[1] > 0:
        shape = (x.shape[0], x.shape[1] * y.shape[1])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="outer_prod", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def factorization_machine(input, factor_size, param_attr=None, name=None):
    """A factorization machine's second-order term, [B, 1], over a
    parameter V [D, factor_size]."""
    helper = LayerHelper("factorization_machine", param_attr=param_attr,
                         name=name)
    v = helper.create_parameter(param_attr, shape=[input.shape[-1],
                                                   factor_size],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], 1))
    helper.append_op(type="factorization_machine",
                     inputs={"X": [input], "V": [v]},
                     outputs={"Out": [out]})
    return out


def scale_sub_region(x, indices, value=1.0, name=None):
    """x [B, C, H, W] times ``value`` inside each sample's 1-based
    inclusive box, indices [B, 6] = (c1, c2, h1, h2, w1, w2)."""
    helper = LayerHelper("scale_sub_region", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="scale_sub_region",
                     inputs={"X": [x], "Indices": [indices]},
                     outputs={"Out": [out]}, attrs={"value": value})
    return out


# -- the sequence family (layers/nn.py:251, 1072-1152, 1522) -----------------
def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: ``fc([x_t, hidden_t_prev], 4 * H)`` to the gates,
    then the lstm_unit op with C_prev; returns (hidden, cell)."""
    size = cell_t_prev.shape[-1]
    gates = fc([x_t, hidden_t_prev], 4 * size, param_attr=param_attr,
               bias_attr=bias_attr if bias_attr is not None else True)
    helper = LayerHelper("lstm_unit_core", name=name)
    c = helper.create_variable_for_type_inference(x_t.dtype,
                                                  cell_t_prev.shape)
    h = helper.create_variable_for_type_inference(x_t.dtype,
                                                  cell_t_prev.shape)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def sequence_softmax(input, name=None):
    """Softmax over each sequence's steps, [B, T] or [B, T, 1]."""
    return _unary_layer("sequence_softmax", input, None, name)


def sequence_expand(x, y, name=None):
    """A [B, D] x broadcast along a time-major y's steps ([B, T, ...]);
    an x of y's rank passes through, masked by y's lengths."""
    helper = LayerHelper("sequence_expand", name=name)
    shape = None
    if x.shape is not None and y.shape is not None:
        if len(x.shape) == 2 and len(y.shape) >= 3:
            shape = (x.shape[0], y.shape[1]) + tuple(x.shape[1:])
        else:
            shape = tuple(x.shape)
    out = helper.create_variable_for_type_inference(x.dtype, shape,
                                                    lod_level=1)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_concat(input, axis=0, name=None):
    """Each row's sequences of ``input`` joined along time."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype,
                                                    lod_level=1)
    helper.append_op(type="sequence_concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sequence_reshape(input, new_dim, name=None):
    """[B, T, D] to [B, T * D / new_dim, new_dim], the lengths scaled."""
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, lod_level=1)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def sequence_slice(input, offset, length, name=None):
    """Each row's steps [offset, offset + length)."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, input.shape, lod_level=1)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_reverse(x, name=None):
    """Each row's steps in reverse order, the padding in place."""
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, x.shape, lod_level=x.lod_level)
    helper.append_op(type="sequence_reverse", inputs={"X": [x]},
                     outputs={"Y": [out]})
    return out


def lod_reset(x, y=None, target_lod=None, name=None):
    """x with the lengths of y's values, or of ``target_lod``'s
    offsets."""
    helper = LayerHelper("lod_reset", name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, x.shape, lod_level=1)
    ins = {"X": [x]}
    if y is not None:
        ins["Y"] = [y]
    helper.append_op(type="lod_reset", inputs=ins, outputs={"Out": [out]},
                     attrs={"target_lod": target_lod or []})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead convolution over a parameter Filter
    [future_context_size + 1, D]."""
    helper = LayerHelper("row_conv", param_attr=param_attr, name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[future_context_size + 1, d],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(
        input.dtype, input.shape, lod_level=input.lod_level)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]})
    return helper.append_activation(out, act)


def kmax_sequence_score(input, beam_size=1, name=None):
    """The positions of each sequence's ``beam_size`` top scores, int64,
    -1 padded (KmaxSeqScoreLayer)."""
    helper = LayerHelper("kmax_seq_score", name=name)
    out = helper.create_variable_for_type_inference(
        "int64", (input.shape[0], beam_size) if input.shape else None)
    helper.append_op(type="kmax_seq_score", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"beam_size": beam_size})
    return out


# -- sampled outputs and structured prediction (layers/nn.py:1167-1262) -------
def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=10, name=None):
    """Noise-contrastive estimation's cost [B, 1] over parameters Weight
    [num_total_classes, D] and Bias [num_total_classes]."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(
        ParamAttr._to_attr(bias_attr) or ParamAttr(),
        shape=[num_total_classes], dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    sl = helper.create_variable_for_type_inference(input.dtype)
    slab = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="nce",
                     inputs={"Input": [input], "Label": [label],
                             "Weight": [w], "Bias": [b]},
                     outputs={"Cost": [cost], "SampleLogits": [sl],
                              "SampleLabels": [slab]},
                     attrs={"num_neg_samples": num_neg_samples,
                            "num_total_classes": num_total_classes})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid's cost [B, 1] over parameters W
    [num_classes - 1, D] and Bias [num_classes - 1]."""
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[num_classes - 1, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(
        ParamAttr._to_attr(bias_attr) or ParamAttr(),
        shape=[num_classes - 1], dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="hierarchical_sigmoid",
                     inputs={"X": [input], "Label": [label], "W": [w],
                             "Bias": [b]},
                     outputs={"Out": [out], "PreOut": [pre]},
                     attrs={"num_classes": num_classes})
    return out


def linear_chain_crf(input, label, param_attr=None, name=None):
    """The linear-chain CRF's negative log-likelihood [B, 1] over a
    parameter Transition [D + 2, D] (rows 0 and 1 the start and end
    scores)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr,
                         name=name)
    ntags = input.shape[-1]
    transition = helper.create_parameter(
        param_attr, shape=[ntags + 2, ntags], dtype=input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    emission_exps = helper.create_variable_for_type_inference(input.dtype)
    transition_exps = helper.create_variable_for_type_inference(input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label]},
                     outputs={"Alpha": [alpha],
                              "EmissionExps": [emission_exps],
                              "TransitionExps": [transition_exps],
                              "LogLikelihood": [ll]})
    return ll


def crf_decoding(input, param_attr, label=None, name=None):
    """Viterbi decoding under the Transition named by ``param_attr``: the
    training program's parameter when the program holds it, else one
    declared here (a standalone decode program, loaded)."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr, name=name)
    attr = ParamAttr._to_attr(param_attr)
    gb = helper.main_program.global_block()
    if attr.name and gb.has_var(attr.name):
        transition = gb.var(attr.name)
    else:
        ntags = input.shape[-1]
        transition = helper.create_parameter(
            attr, shape=[ntags + 2, ntags], dtype=input.dtype)
    out = helper.create_variable_for_type_inference("int64", lod_level=1)
    ins = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        ins["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [out]})
    return out


def warpctc(input, label, blank=0, norm_by_times=False, name=None):
    """The CTC loss [B, 1] of pre-softmax ``input`` against ``label``,
    by the JAX package's recursion (no external warp-ctc library)."""
    helper = LayerHelper("warpctc", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="warpctc",
                     inputs={"Logits": [input], "Label": [label]},
                     outputs={"Loss": [out]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             name=None):
    """Max-pool each ROI (rows of ``rois`` [R, 5]: batch index, x1, y1,
    x2, y2) of ``input`` [N, C, H, W] to [R, C, pooled_height,
    pooled_width]."""
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    argmax = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="roi_pool",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [out], "Argmax": [argmax]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def moe(input, num_experts, expert_hidden, top_k=2, capacity_factor=1.25,
        act="relu", gate_attr=None, param_attr=None, name=None):
    """A mixture-of-experts FFN (GShard's routing, ``ops/moe_ops.py``) on
    ``input`` [B, D] or [B, T, D].  The expert weights [E, D, H] and
    [E, H, D] carry the JAX package's ``('ep', None, None)`` sharding,
    which one card ignores.  Returns (out, aux_loss): add ``aux_weight *
    aux_loss`` to the training loss to keep the experts evenly loaded."""
    import copy
    helper = LayerHelper("moe", param_attr=param_attr, name=name)
    D = input.shape[-1]
    gate_w = helper.create_parameter(
        gate_attr, shape=[D, num_experts], dtype=input.dtype)
    pa = copy.copy(param_attr) if param_attr is not None else ParamAttr()
    if getattr(pa, "sharding", None) is None:
        pa.sharding = ("ep", None, None)
    w1 = helper.create_parameter(
        pa, shape=[num_experts, D, expert_hidden], dtype=input.dtype)
    w2 = helper.create_parameter(
        ParamAttr(sharding=pa.sharding),
        shape=[num_experts, expert_hidden, D], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(
        input.dtype, input.shape, lod_level=input.lod_level)
    aux = helper.create_variable_for_type_inference("float32", ())
    helper.append_op(type="moe",
                     inputs={"X": [input], "GateW": [gate_w],
                             "W1": [w1], "W2": [w2]},
                     outputs={"Out": [out], "AuxLoss": [aux]},
                     attrs={"top_k": top_k,
                            "capacity_factor": capacity_factor,
                            "activation": act})
    if input.lod_level:
        _copy_len(helper, input, out)
    return out, aux
