"""Weight-decay regularizers appended as grad-graph ops (counterpart of
``paddle_tpu/regularizer.py``; reference: fluid/regularizer.py
append_regularization_ops)."""
from __future__ import annotations

from .layer_helper import LayerHelper


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(
            param.dtype, param.shape)
        helper.append_op(type="scale", inputs={"X": [param]},
                         outputs={"Out": [decay]},
                         attrs={"scale": self._coeff})
        out = helper.create_variable_for_type_inference(
            param.dtype, param.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [grad], "Y": [decay]},
                         outputs={"Out": [out]})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(
            param.dtype, param.shape)
        helper.append_op(type="sign", inputs={"X": [param]},
                         outputs={"Out": [sign]})
        decay = helper.create_variable_for_type_inference(
            param.dtype, param.shape)
        helper.append_op(type="scale", inputs={"X": [sign]},
                         outputs={"Out": [decay]},
                         attrs={"scale": self._coeff})
        out = helper.create_variable_for_type_inference(
            param.dtype, param.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [grad], "Y": [decay]},
                         outputs={"Out": [out]})
        return out


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            out.append((param, grad))
        else:
            out.append((param, reg.append_regularization_op(param, grad)))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
