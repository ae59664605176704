"""Gradient clipping appended as grad-graph ops (counterpart of
``paddle_tpu/clip.py``; reference: fluid/clip.py — ClipByValue,
ClipByNorm, ClipByGlobalNorm)."""
from __future__ import annotations

from .layer_helper import LayerHelper


class BaseGradientClipAttr:
    def create_operators(self, param, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def create_operators(self, param, grad):
        helper = LayerHelper("clip_grad")
        out = helper.create_variable_for_type_inference(grad.dtype, grad.shape)
        helper.append_op(type="clip", inputs={"X": [grad]},
                         outputs={"Out": [out]},
                         attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        helper = LayerHelper("clip_grad_norm")
        out = helper.create_variable_for_type_inference(grad.dtype, grad.shape)
        helper.append_op(type="clip_by_norm", inputs={"X": [grad]},
                         outputs={"Out": [out]},
                         attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """scale = clip_norm / max(global_norm, clip_norm), applied to every grad."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators_group(self, params_grads):
        from . import layers
        helper = LayerHelper("global_norm_clip")
        sq_sums = []
        for _, g in params_grads:
            sq = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op(type="squared_l2_norm", inputs={"X": [g]},
                             outputs={"Out": [sq]})
            sq_sums.append(sq)
        total = layers.sums(sq_sums) if len(sq_sums) > 1 else sq_sums[0]
        gnorm = layers.sqrt(total)
        clip_var = layers.fill_constant([1], "float32", self.clip_norm)
        denom = layers.elementwise_max(gnorm, clip_var)
        scale = layers.elementwise_div(clip_var, denom)
        return [(p, layers.elementwise_mul(g, scale))
                for p, g in params_grads]


ErrorClipByValue = GradientClipByValue  # forward-activation clip parity alias


def append_gradient_clip_ops(params_grads):
    """Global-norm clipping groups only the params annotated with it;
    per-param clips apply individually; unannotated grads pass through."""
    group = [(p, g) for p, g in params_grads
             if isinstance(getattr(p, "gradient_clip_attr", None),
                           GradientClipByGlobalNorm)]
    grouped = {}
    if group:
        gc = group[0][0].gradient_clip_attr
        grouped = {p.name: (p, ng)
                   for p, ng in gc.create_operators_group(group)}
    out = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip_attr", None)
        if p.name in grouped:
            out.append(grouped[p.name])
        elif clip is None:
            out.append((p, g))
        else:
            out.append(clip.create_operators(p, g))
    return out


def set_gradient_clip(clip, param_list=None, program=None):
    from .core.program import default_main_program
    program = program or default_main_program()
    params = param_list or program.all_parameters()
    for p in params:
        if isinstance(p, str):
            p = program.global_block().var(p)
        p.gradient_clip_attr = clip
