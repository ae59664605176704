"""The core of the v1 config DSL (counterpart of the core of
``paddle_tpu/trainer_config_helpers/__init__.py``; reference:
python/paddle/trainer_config_helpers/ and trainer/config_parser.py).

A v1 config file (the reference's benchmark configs, v1 demos) is plain
Python evaluated with this DSL in scope; each DSL call appends to the
current default program of this package, so ``load_v1_config`` turns a
config file into a :class:`V1Config` (programs, outputs, settings) that
trains with the port's executor on the card or the CPU.  The elastic
service's workers rebuild their model this way.

The core covers ``settings``, ``get_config_arg``,
``define_py_data_sources2``, ``data_layer``, ``fc_layer``,
``img_conv_layer``, ``img_pool_layer``, ``img_cmrnorm_layer``,
``batch_norm_layer``, ``img_conv_group``, ``dropout_layer``,
``embedding_layer``, ``concat_layer``, ``addto_layer``,
``simple_lstm``/``lstmemory``, ``last_seq``/``first_seq``/
``max_pooling_seq``, the costs, ``outputs``, and the activation,
pooling, optimizer and regularization objects.  The JAX package's
submodules (``sequence``, ``extra_layers``, ``networks_extra``,
``layer_math``) are not here: a config that names one of their names
raises ``NotImplementedError`` naming ROADMAP Queue A item 10, as does
``img_conv_layer(trans=True)`` (``conv2d_transpose``, item 4).
"""
from __future__ import annotations

import copy
import math
import sys
from typing import Optional

import numpy as np

from .. import layers as L
from .. import optimizer as opt_mod
from .. import regularizer as reg_mod
from ..param_attr import ParamAttr

__all__ = [
    "settings", "get_config_arg", "define_py_data_sources2", "outputs",
    "inputs", "Inputs", "Outputs",
    "data_layer", "fc_layer", "img_conv_layer", "img_pool_layer",
    "img_cmrnorm_layer", "batch_norm_layer", "dropout_layer",
    "embedding_layer", "concat_layer", "addto_layer", "simple_lstm",
    "lstmemory", "last_seq", "first_seq", "max_pooling_seq",
    "classification_cost", "cross_entropy", "cross_entropy_cost",
    "regression_cost", "mse_cost",
    "img_conv_group", "conv_projection", "ExtraAttr",
    "ExtraLayerAttribute", "ParamAttr", "default_device",
    "LinearActivation", "ReluActivation", "SigmoidActivation",
    "TanhActivation", "SoftmaxActivation", "IdentityActivation",
    "STanhActivation", "ExpActivation", "AbsActivation",
    "SquareActivation", "BReluActivation", "SoftReluActivation",
    "MaxPooling", "AvgPooling", "SumPooling",
    "CudnnMaxPooling", "CudnnAvgPooling", "ExpandLevel", "AggregateLevel",
    "MomentumOptimizer", "AdamOptimizer", "AdaGradOptimizer",
    "RMSPropOptimizer", "AdaDeltaOptimizer",
    "L1Regularization", "L2Regularization", "ModelAverage",
    "load_v1_config", "V1Config",
]

# Names the JAX package's DSL takes from its submodules (sequence.py,
# extra_layers.py, networks_extra.py, layer_math.py), which come with
# ROADMAP Queue A item 10.  A config that names one raises at the name.
ITEM_10_NAMES = frozenset((
    # sequence.py
    "memory", "recurrent_group", "StaticInput", "GeneratedInput",
    "SubsequenceInput", "mixed_layer", "MixedLayerType",
    "full_matrix_projection", "trans_full_matrix_projection",
    "table_projection", "identity_projection", "dotmul_projection",
    "scaling_projection", "slice_projection", "recurrent_layer",
    "lstmemory_group", "grumemory", "gru_group", "simple_gru",
    "beam_search", "crf_layer", "crf_decoding_layer", "sum_evaluator",
    "chunk_evaluator", "seqtext_printer_evaluator",
    "classification_error_evaluator", "maxid_layer", "pooling_layer",
    "sequence_conv_pool", "text_conv_pool", "bidirectional_lstm",
    "expand_layer", "scaling_layer", "simple_attention", "gru_step_layer",
    "power_layer", "slope_intercept_layer", "sum_to_one_norm_layer",
    "cos_sim", "trans_layer", "repeat_layer", "seq_reshape_layer",
    "print_layer",
    # extra_layers.py and networks_extra.py
    "BeamInput", "LayerOutput", "LayerType", "bidirectional_gru",
    "bilinear_interp_layer", "block_expand_layer", "clip_layer",
    "context_projection", "conv_operator", "conv_shift_layer",
    "convex_comb_layer", "crop_layer", "cross_channel_norm_layer",
    "cross_entropy_over_beam", "cross_entropy_with_selfnorm", "ctc_layer",
    "detection_output_layer", "dot_prod_layer", "dot_product_attention",
    "dotmul_operator", "eos_layer", "factorization_machine",
    "gated_unit_layer", "get_output_layer", "gru_step_naive_layer",
    "gru_unit", "hsigmoid", "huber_classification_cost",
    "huber_regression_cost", "img_conv3d_layer", "img_conv_bn_pool",
    "img_pool3d_layer", "img_separable_conv", "interpolation_layer",
    "kmax_seq_score_layer", "l2_distance_layer", "lambda_cost",
    "layer_support", "linear_comb_layer", "lstm_step_layer",
    "lstmemory_unit", "maxout_layer", "multi_binary_label_cross_entropy",
    "multi_head_attention", "multibox_loss_layer", "multiplex_layer",
    "nce_layer", "out_prod_layer", "pad_layer", "prelu_layer",
    "printer_layer", "priorbox_layer", "rank_cost", "resize_layer",
    "roi_pool_layer", "rotate_layer", "row_conv_layer",
    "row_l2_norm_layer", "sampling_id_layer", "scale_shift_layer",
    "scale_sub_region_layer", "selective_fc_layer", "seq_concat_layer",
    "seq_slice_layer", "simple_gru2", "simple_img_conv_pool", "small_vgg",
    "smooth_l1_cost", "spp_layer", "square_error_cost",
    "sub_nested_seq_layer", "sub_seq_layer", "sum_cost",
    "switch_order_layer", "tensor_layer", "vgg_16_network",
    "warp_ctc_layer",
    # layer_math.py
    "layer_math",
))


def _item_10(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"v1 config DSL: {name!r} belongs to the DSL's sequence/extra "
        f"layers, which are not ported yet (ROADMAP.md Queue A item 10, "
        f"the legacy surfaces); the port has the DSL's core only")


def __getattr__(name):
    # ``from paddle.trainer_config_helpers import lstmemory_group`` in a
    # config lands here through the import shim
    if name in ITEM_10_NAMES:
        raise _item_10(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class _ConfigNamespace(dict):
    """The globals a config runs in: a name of the DSL's submodules
    raises naming its ROADMAP item (at the lookup, inside the config's
    own functions too), any other unknown name is the ordinary
    NameError."""

    def __missing__(self, key):
        if key in ITEM_10_NAMES:
            raise _item_10(key)
        raise KeyError(key)


def track_layer(name, out):
    """Record a named layer output (config-level ``Outputs()``)."""
    if name:
        _state.named_layers[name] = out
    return out


def _activate(out, act_name):
    """Append the activation op ``act_name`` after ``out`` (the JAX DSL
    calls the layers module's function of that name, which appends the
    same op)."""
    if not act_name:
        return out
    from ..layer_helper import LayerHelper
    return LayerHelper(act_name).append_activation(out, act_name)


# ---------------------------------------------------------------------------
# config-level state
# ---------------------------------------------------------------------------
class _ConfigState:
    def __init__(self):
        self.args = {}
        self.settings = {}
        self.outputs = []
        self.data_sources = None
        self.data_layers = {}
        self.named_layers = {}
        self.evaluators = []
        self.input_order = None
        self.defaults = {}      # default_momentum/default_decay_rate values
        # loader-declared sequence inputs (the v1 DataProvider's
        # *_sequence declarations, which configs never carried themselves):
        # data_layer names listed here build as lod_level-1 vars
        self.sequence_inputs = set()


_state = _ConfigState()


def get_config_arg(name, type_=str, default=None):
    """command-line config args (config_parser get_config_arg)."""
    v = _state.args.get(name, default)
    if v is None:
        return None
    if type_ is bool and isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return type_(v)


def settings(batch_size=None, learning_rate=1e-3, learning_method=None,
             regularization=None, gradient_clipping_threshold=None,
             model_average=None, learning_rate_decay_a=0.0,
             learning_rate_decay_b=0.0, **kw):
    _state.settings = {
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "learning_method": learning_method,
        "regularization": regularization,
        "gradient_clipping_threshold": gradient_clipping_threshold,
        "model_average": model_average,
        "learning_rate_decay_a": learning_rate_decay_a,
        "learning_rate_decay_b": learning_rate_decay_b,
    }
    _state.settings.update(kw)


def define_py_data_sources2(train_list, test_list, module=None, obj=None,
                            args=None):
    """Recorded for the caller; the runner feeds through a reader and
    DataFeeder instead of the embedded PyDataProvider2."""
    _state.data_sources = {"train_list": train_list, "test_list": test_list,
                           "module": module, "obj": obj, "args": args}


def outputs(*vars_):
    flat = []
    for v in vars_:
        if isinstance(v, (list, tuple)):
            flat.extend(v)          # v1 allowed outputs([a, b])
        else:
            flat.append(v)
    _state.outputs = flat


def inputs(*layers):
    """v1 inputs(): fixes the data-layer feed order."""
    _state.input_order = [getattr(v, "name", v) for v in layers]


def Inputs(*names):
    """config_parser Inputs(): name-based variant used by .conf files."""
    _state.input_order = list(names)


def Outputs(*names):
    """config_parser Outputs(): resolve by layer name at config close."""
    _state.outputs = [_state.named_layers.get(n, n) for n in names]


def default_device(device_id):
    """v1 per-layer device placement hint: the executor places every op
    on its one device; accepted for config compatibility."""


class ModelAverage:
    """v1 settings(model_average=...): recorded; the trainer applies
    parameter averaging over a trailing window when configured."""

    def __init__(self, average_window, max_average_window=None,
                 do_average_in_cpu=False):
        self.average_window = average_window
        self.max_average_window = max_average_window


# ---------------------------------------------------------------------------
# activation / pooling / optimizer / regularization objects
# ---------------------------------------------------------------------------
class _Act:
    act = None

    def __init__(self):
        pass


class LinearActivation(_Act):
    act = None


IdentityActivation = LinearActivation


class ReluActivation(_Act):
    act = "relu"


class SigmoidActivation(_Act):
    act = "sigmoid"


class TanhActivation(_Act):
    act = "tanh"


class SoftmaxActivation(_Act):
    act = "softmax"


class STanhActivation(_Act):
    act = "stanh"              # 1.7159 * tanh(2x/3), STanhActivation.cpp


class ExpActivation(_Act):
    act = "exp"


class AbsActivation(_Act):
    act = "abs"


class SquareActivation(_Act):
    act = "square"


class BReluActivation(_Act):
    act = "brelu"


class SoftReluActivation(_Act):
    act = "softrelu"


def _act_name(a):
    if a is None:
        return None
    if isinstance(a, str):
        return a
    return a.act


class MaxPooling:
    ptype = "max"


class AvgPooling:
    ptype = "avg"


class SumPooling:
    ptype = "sum"


CudnnMaxPooling = MaxPooling     # the cudnn variants are the same pools
CudnnAvgPooling = AvgPooling


class ExpandLevel:
    """v1 expand_layer levels (layers.py ExpandLevel)."""
    FROM_NO_SEQUENCE = 0
    FROM_SEQUENCE = 1
    FROM_TIMESTEP = FROM_NO_SEQUENCE


class AggregateLevel:
    """v1 pooling/agg levels (layers.py AggregateLevel)."""
    TO_NO_SEQUENCE = 0
    TO_SEQUENCE = 1
    EACH_TIMESTEP = TO_NO_SEQUENCE
    EACH_SEQUENCE = TO_SEQUENCE


class MomentumOptimizer:
    def __init__(self, momentum=0.9, sparse=False):
        self.momentum = momentum

    def make(self, lr, reg):
        return opt_mod.Momentum(learning_rate=lr, momentum=self.momentum,
                                regularization=reg)


class AdamOptimizer:
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def make(self, lr, reg):
        return opt_mod.Adam(learning_rate=lr, beta1=self.beta1,
                            beta2=self.beta2, epsilon=self.epsilon,
                            regularization=reg)


class AdaGradOptimizer:
    def make(self, lr, reg):
        return opt_mod.Adagrad(learning_rate=lr, regularization=reg)


class RMSPropOptimizer:
    def make(self, lr, reg):
        return opt_mod.RMSProp(learning_rate=lr, regularization=reg)


class AdaDeltaOptimizer:
    def make(self, lr, reg):
        return opt_mod.Adadelta(learning_rate=lr, regularization=reg)


class L1Regularization:
    def __init__(self, rate):
        self.rate = rate

    def make(self):
        return reg_mod.L1Decay(self.rate)


class L2Regularization:
    def __init__(self, rate):
        self.rate = rate

    def make(self):
        return reg_mod.L2Decay(self.rate)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def data_layer(name, size, height=None, width=None, depth=None,
               is_seq=False, lod_level=None, **kw):
    """v1 data_layer: flat ``size`` input.  Image configs pass height/width
    via img_conv_layer's num_channels; sequence configs treat size as the
    vocab.  The var records ``v1_size`` so embedding/conv can recover
    semantics.  ``is_seq``/``lod_level`` mark a dense-vector-sequence input
    (the role the v1 DataProvider's ``dense_vector_sequence`` declaration
    played — config-side here because providers are plain readers): the
    feed becomes padded [B, T, size] + ``name@LEN``, e.g. per-query
    document lists for lambda_cost."""
    if not is_seq and lod_level is None and name in _state.sequence_inputs:
        is_seq = True
    lod = 1 if is_seq else int(lod_level or 0)
    v = L.data(name, shape=[size], dtype="float32", lod_level=lod)
    v.v1_size = size
    _state.data_layers[name] = v
    return v


def _as_image(input, num_channels):
    """Reshape a flat v1 data layer to [C, H, W] (square images, the v1
    convention when height/width are unspecified)."""
    if input.shape is not None and len(input.shape) == 4:
        return input
    size = getattr(input, "v1_size", None) or int(np.prod(input.shape[1:]))
    hw = int(round(math.sqrt(size // num_channels)))
    return L.reshape(input, [-1, num_channels, hw, hw])


class ExtraLayerAttribute:
    """v1 ExtraLayerAttribute (drop_rate is the only knob the benchmark
    configs use)."""

    def __init__(self, drop_rate=None, **kw):
        self.drop_rate = drop_rate


ExtraAttr = ExtraLayerAttribute


def _apply_layer_attr(out, layer_attr):
    if layer_attr is not None and getattr(layer_attr, "drop_rate", None):
        out = L.dropout(out, layer_attr.drop_rate)
    return out


def _v1_named_attr(attr, pname):
    """v1 deterministic parameter naming (config_parser.py: an explicitly
    named layer owns parameters ``_<layer>.w<i>`` / ``_<layer>.wbias``) —
    what api.GradientMachine parameter sharing keys on across separately
    built machines (the GAN trainer's copy_shared_parameters idiom).
    Clones the attr (configs reuse one ParamAttr across layers); explicit
    attr names and disabled (False) attrs pass through untouched."""
    if attr is False or pname is None:
        return attr
    attr = ParamAttr._to_attr(attr)
    if attr is None or attr.name is not None:
        return attr
    attr = copy.copy(attr)
    attr.name = pname
    return attr


def fc_layer(input, size, act=None, name=None, param_attr=None,
             bias_attr=None, layer_attr=None, **kw):
    inputs = input if isinstance(input, (list, tuple)) else [input]
    flat = []
    for v in inputs:
        if v.shape is not None and len(v.shape) > 2 and v.lod_level == 0:
            v = L.reshape(v, [-1, int(np.prod(v.shape[1:]))])
        flat.append(v)
    nfd = 2 if flat[0].lod_level else 1
    if name is not None:
        if isinstance(param_attr, (list, tuple)):
            param_attr = [_v1_named_attr(a, f"_{name}.w{i}")
                          for i, a in enumerate(param_attr)]
        elif len(flat) > 1:
            param_attr = [_v1_named_attr(param_attr, f"_{name}.w{i}")
                          for i in range(len(flat))]
        else:
            param_attr = _v1_named_attr(param_attr, f"_{name}.w0")
        bias_attr = _v1_named_attr(bias_attr, f"_{name}.wbias")
    out = L.fc(flat if len(flat) > 1 else flat[0], size=size,
               num_flatten_dims=nfd, act=_act_name(act), name=name,
               param_attr=param_attr, bias_attr=bias_attr)
    return track_layer(name, _apply_layer_attr(out, layer_attr))


def img_conv_layer(input, filter_size, num_filters, name=None,
                   num_channels=None, act=None, groups=1, stride=1,
                   padding=0, bias_attr=None, param_attr=None,
                   shared_biases=True, layer_attr=None, filter_size_y=None,
                   stride_y=None, padding_y=None, trans=False, **kw):
    if num_channels is not None:
        input = _as_image(input, num_channels)
    fs = (filter_size, filter_size_y) if filter_size_y else filter_size
    st = (stride, stride_y) if stride_y else stride
    pd = (padding, padding_y) if padding_y else padding
    if trans:
        raise NotImplementedError(
            "v1 config DSL: img_conv_layer(trans=True) needs the "
            "conv2d_transpose op, which is not ported yet (ROADMAP.md "
            "Queue A item 4, the remaining ops and layers)")
    return L.conv2d(input, num_filters=num_filters, filter_size=fs, stride=st,
             padding=pd, groups=groups, act=_act_name(act), name=name,
             param_attr=_v1_named_attr(param_attr, f"_{name}.w0"
                                       if name else None),
             bias_attr=_v1_named_attr(bias_attr, f"_{name}.wbias"
                                      if name else None))


def img_pool_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                   name=None, num_channels=None, ceil_mode=True,
                   pool_size_y=None, stride_y=None, padding_y=None, **kw):
    if num_channels is not None:
        input = _as_image(input, num_channels)
    ptype = pool_type.ptype if pool_type is not None else "max"
    ps = (pool_size, pool_size_y) if pool_size_y is not None else pool_size
    st = (stride, stride_y) if stride_y is not None else stride
    pd = (padding, padding_y) if padding_y is not None else padding
    return L.pool2d(input, pool_size=list(ps) if isinstance(ps, tuple)
                    else ps, pool_type=ptype,
                    pool_stride=list(st) if isinstance(st, tuple) else st,
                    pool_padding=list(pd) if isinstance(pd, tuple) else pd,
                    ceil_mode=ceil_mode, name=name)


def img_cmrnorm_layer(input, size=5, scale=0.0001, power=0.75, name=None,
                      num_channels=None, **kw):
    """v1 cross-map response norm == LRN (ImgCMRNormLayer)."""
    if num_channels is not None:
        input = _as_image(input, num_channels)
    return L.lrn(input, n=size, alpha=scale, beta=power, name=name)


def batch_norm_layer(input, act=None, name=None, num_channels=None,
                     bias_attr=None, param_attr=None, use_global_stats=None,
                     moving_average_fraction=0.9, **kw):
    if num_channels is not None and (input.shape is None or
                                     len(input.shape) != 4):
        input = _as_image(input, num_channels)
    return L.batch_norm(input, act=_act_name(act),
                        momentum=moving_average_fraction,
                        param_attr=_v1_named_attr(param_attr, f"_{name}.w0"
                                                  if name else None),
                        bias_attr=_v1_named_attr(bias_attr, f"_{name}.wbias"
                                                 if name else None),
                        moving_mean_name=f"_{name}.w1" if name else None,
                        moving_variance_name=f"_{name}.w2" if name else None,
                        use_global_stats=use_global_stats,
                        name=name)


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type=None, param_attr=None, **kw):
    """trainer_config_helpers.networks img_conv_group."""
    from .. import nets
    if num_channels is not None:
        input = _as_image(input, num_channels)
    return nets.img_conv_group(
        input, conv_num_filter=list(conv_num_filter), pool_size=pool_size,
        conv_padding=conv_padding, conv_filter_size=conv_filter_size,
        conv_act=_act_name(conv_act),
        conv_with_batchnorm=conv_with_batchnorm,
        conv_batchnorm_drop_rate=conv_batchnorm_drop_rate,
        pool_stride=pool_stride,
        pool_type=pool_type.ptype if pool_type is not None else "max",
        # v1 PoolLayer sizes outputs with ceil (img_pool_layer's default
        # here too); light_mnist's 4-stage chain needs it to keep spatial
        # dims >= 1 (28 -> ... -> 1 instead of collapsing to 0)
        pool_ceil_mode=True,
        param_attr=param_attr)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, **kw):
    """v1 conv projection (used inside MixedLayer/concat): plain conv here."""
    return img_conv_layer(input, filter_size=filter_size,
                          num_filters=num_filters,
                          num_channels=num_channels, stride=stride,
                          padding=padding)


def dropout_layer(input, dropout_rate, name=None):
    return L.dropout(input, dropout_prob=dropout_rate, name=name)


def embedding_layer(input, size, name=None, param_attr=None, **kw):
    vocab = getattr(input, "v1_size", None)
    if vocab is None:
        raise ValueError("embedding_layer input must be a data_layer with "
                         "its vocab as size")
    ids = input
    if ids.dtype != "int64":
        # v1 integer_value_sequence arrives as the same data layer; re-type
        ids.dtype = "int64"
        ids.lod_level = 1
        ids.shape = (-1, -1)
    return L.embedding(ids, size=[vocab, size], param_attr=param_attr,
                       name=name)


def concat_layer(input, act=None, name=None, bias_attr=None, **kw):
    """v1 concat (axis 1 = features/channels).  Items may be layer outputs
    (the projections that ConcatenateLayer2 also took come with the
    sequence DSL, ROADMAP item 10)."""
    items = list(input)
    out = L.concat(items, axis=1, name=name)
    if bias_attr not in (None, False):
        from ..layer_helper import LayerHelper
        helper = LayerHelper("concat_bias")
        if out.shape and out.shape[1] and out.shape[1] > 0:
            csize = out.shape[1]
        else:
            # infer the concat width: sum of the inputs' concat-axis dims
            csize = sum(it.shape[1] for it in items)
        b = helper.create_parameter(
            bias_attr if isinstance(bias_attr, ParamAttr) else ParamAttr(),
            shape=[csize], dtype=out.dtype, is_bias=True)
        axis = 1 if (out.shape is not None and len(out.shape) == 4) else -1
        out = L.elementwise_add(out, b, axis=axis)
    return track_layer(name, _activate(out, _act_name(act)))


def addto_layer(input, act=None, name=None, bias_attr=None, **kw):
    inputs = input if isinstance(input, (list, tuple)) else [input]
    out = inputs[0]
    for v in inputs[1:]:
        out = L.elementwise_add(out, v)
    return _activate(out, _act_name(act))


def simple_lstm(input, size, name=None, reverse=False, act=None,
                gate_act=None, **kw):
    """trainer_config_helpers simple_lstm: fc(4*size) + lstmemory."""
    proj = L.fc(input, size=size * 4, num_flatten_dims=2)
    hid, _ = L.dynamic_lstm(proj, size=size * 4, is_reverse=reverse,
                            name=name)
    return hid


def lstmemory(input, name=None, reverse=False, act=None, gate_act=None,
              size=None, **kw):
    """v1 lstmemory: input must already be the 4x gate projection."""
    hid, _ = L.dynamic_lstm(input, size=input.shape[-1], is_reverse=reverse,
                            name=name)
    return hid


def last_seq(input, name=None, **kw):
    return track_layer(name, L.sequence_last_step(input, name=name))


def first_seq(input, name=None, **kw):
    return track_layer(name, L.sequence_first_step(input, name=name))


def max_pooling_seq(input, name=None, **kw):
    return track_layer(name, L.sequence_pool(input, "max", name=name))


def _label_layer(label):
    if getattr(label, "is_data", False) and label.dtype != "int64":
        label.dtype = "int64"
        if label.shape is not None and label.shape[-1] != 1:
            label.shape = (-1, 1)
    return label


def classification_cost(input, label, name=None, evaluator=None, **kw):
    label = _label_layer(label)
    return L.mean(L.cross_entropy(input, label), name=name)


def cross_entropy_cost(input, label, name=None, **kw):
    return classification_cost(input, label, name)


cross_entropy = cross_entropy_cost


def regression_cost(input, label, name=None, **kw):
    return L.mean(L.square_error_cost(input, label), name=name)


mse_cost = regression_cost


# -- default_decorators.py shims (model_zoo configs call these) -------------
def default_momentum(m):
    """default_decorators.py: the momentum Settings('momentum') uses, and
    the fallback when settings() names no learning_method."""
    _state.defaults["momentum"] = m


def default_decay_rate(r):
    """default_decorators.py: weight decay applied when settings() names
    no regularization (consumed by make_optimizer)."""
    _state.defaults["decay_rate"] = r


def _default_noop(*a, **kw):
    return None


# initial_std/mean/strategy/smart map onto the global Xavier/defaults the
# initializer module already applies; batch-regularization and clipping
# are optimizer-level knobs read from settings()
default_initial_std = default_initial_mean = _default_noop
default_initial_strategy = default_initial_smart = _default_noop
default_num_batches_regularization = _default_noop
default_gradient_clipping_threshold = _default_noop

def Settings(algorithm="sgd", batch_size=None, learning_rate=1e-3,
             learning_method=None, **kw):
    """Raw config_parser Settings() (trainer/config_parser.py) — the
    pre-helpers API the model_zoo configs use; maps onto settings()."""
    method_map = {"adam": AdamOptimizer, "adagrad": AdaGradOptimizer,
                  "rmsprop": RMSPropOptimizer,
                  "adadelta": AdaDeltaOptimizer}
    method = learning_method
    if isinstance(method, str):
        if method in ("momentum", "sgd"):
            method = MomentumOptimizer(
                _state.defaults.get("momentum", 0.9))
        else:
            method = method_map.get(method, MomentumOptimizer)()
    settings(batch_size=batch_size, learning_rate=learning_rate,
             learning_method=method,
             **{k: v for k, v in kw.items()
                if k in ("regularization", "learning_rate_decay_a",
                         "learning_rate_decay_b", "gradient_clipping_threshold")})


__all__ += ["default_momentum", "default_decay_rate",
            "default_initial_std", "default_initial_mean",
            "default_initial_strategy", "default_initial_smart",
            "default_num_batches_regularization",
            "default_gradient_clipping_threshold", "Settings"]


# ---------------------------------------------------------------------------
# config loader
# ---------------------------------------------------------------------------
class V1Config:
    """Result of evaluating a v1 config file: the built program + metadata."""

    def __init__(self, main_program, startup_program, outputs, settings,
                 data_layers, data_sources, evaluators=None,
                 named_layers=None, input_order=None, defaults=None):
        self.main_program = main_program
        self.startup_program = startup_program
        self.outputs = outputs
        self.settings = settings
        self.data_layers = data_layers
        self.data_sources = data_sources
        self.evaluators = evaluators or []
        self.named_layers = named_layers or {}
        self.input_order = input_order
        self.defaults = dict(defaults or {})

    def make_optimizer(self):
        s = self.settings
        lr = s.get("learning_rate", 1e-3)
        decay_a = s.get("learning_rate_decay_a") or 0.0
        decay_b = s.get("learning_rate_decay_b") or 0.0
        if decay_a and decay_b:
            # v1 default LR schedule; builds on the step counter inside the
            # current program (make_optimizer runs under program_guard)
            from .. import lr_decay
            lr = lr_decay.v1_poly_decay(lr, decay_a, decay_b,
                                        s.get("batch_size") or 1)
        reg_obj = s.get("regularization")
        if reg_obj is None and self.defaults.get("decay_rate"):
            reg_obj = L2Regularization(self.defaults["decay_rate"])
        reg = reg_obj.make() if reg_obj is not None else None
        method = s.get("learning_method")
        if method is None:
            return opt_mod.SGD(learning_rate=lr, regularization=reg)
        return method.make(lr, reg)

    def minimize_outputs(self):
        """append_backward + optimizer on the first output (the cost)."""
        from ..core.program import program_guard
        with program_guard(self.main_program, self.startup_program):
            self.make_optimizer().minimize(self.outputs[0])
        return self.outputs[0]


class _import_shim:
    """While a config runs, ``paddle.trainer_config_helpers`` (and
    ``paddle``) resolve to this module, so reference config files that
    import it execute verbatim; afterwards whatever was there before
    (another package's shim, or nothing) is put back."""

    _KEYS = ("paddle", "paddle.trainer_config_helpers")

    def __enter__(self):
        import types
        self._saved = {k: sys.modules.get(k) for k in self._KEYS}
        this = sys.modules[__name__]
        pkg = types.ModuleType("paddle")
        pkg.trainer_config_helpers = this
        sys.modules["paddle"] = pkg
        sys.modules["paddle.trainer_config_helpers"] = this
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        return False


def load_v1_config(path, sequence_inputs=(), **config_args):
    """Evaluate a v1 config file (the config_parser.parse_config role,
    config_parser.py:126) against a fresh program pair.  Python-2-era
    configs work: ``xrange`` is aliased and the ``paddle`` import is
    shimmed to this module while the file runs.  ``sequence_inputs``
    names data layers that the original DataProvider declared as
    sequences; those build as lod_level-1 padded inputs.  A name of the
    DSL's unported submodules raises ``NotImplementedError`` naming
    ROADMAP item 10."""
    from ..core.program import Program, program_guard

    global _state
    _state = _ConfigState()
    _state.args = dict(config_args)
    _state.sequence_inputs = set(sequence_inputs)
    main, startup = Program(), Program()
    ns = _ConfigNamespace({k: globals()[k] for k in __all__
                           if k not in ("load_v1_config", "V1Config")})
    ns["__file__"] = path
    ns["__builtins__"] = __builtins__
    ns["xrange"] = range
    with _import_shim(), program_guard(main, startup):
        with open(path) as f:
            code = compile(f.read(), path, "exec")
        exec(code, ns)
    return V1Config(main, startup, list(_state.outputs),
                    dict(_state.settings), dict(_state.data_layers),
                    _state.data_sources, evaluators=list(_state.evaluators),
                    named_layers=dict(_state.named_layers),
                    input_order=_state.input_order,
                    defaults=dict(_state.defaults))
