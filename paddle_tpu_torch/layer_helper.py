"""LayerHelper: shared parameter/bias/activation plumbing for layer
functions (counterpart of ``paddle_tpu/layer_helper.py``; it draws names
from ``unique_name`` in the same order, so programs match)."""
from __future__ import annotations

from typing import Optional

from .core import unique_name
from .core.program import (Parameter, Variable, default_main_program,
                           default_startup_program)
from .initializer import (ConstantInitializer, Initializer,
                          XavierInitializer)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer: Optional[Initializer] = None
                         ) -> Parameter:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        shape = [int(s) for s in shape]
        # declare in main program (block 0) ...
        kw = ParamAttr(None, None, attr.learning_rate, attr.regularizer,
                       attr.trainable, attr.gradient_clip,
                       attr.sharding).to_kwargs()
        kw.pop("name", None)
        p = self.block.create_parameter(name=name, shape=shape, dtype=dtype,
                                        **kw)
        # ... and emit its initializer into the startup program
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                           persistable=True)
        init(sv, sb)
        return p

    def create_variable_for_type_inference(self, dtype, shape=None,
                                           lod_level=0) -> Variable:
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"), dtype=dtype,
            shape=shape, lod_level=lod_level)

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None) -> Variable:
        gb = self.main_program.global_block()
        return gb.create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            shape=shape, dtype=dtype, persistable=persistable)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        initializer(sv, sb)

    def append_op(self, **kwargs):
        return self.block.append_op(
            kwargs["type"], kwargs.get("inputs"), kwargs.get("outputs"),
            kwargs.get("attrs"))

    def append_bias_op(self, input_var: Variable, bias_attr=None) -> Variable:
        bias_attr = self.kwargs.get("bias_attr", bias_attr)
        # bias_attr=None means CREATE a default bias; only False disables
        if bias_attr is False:
            return input_var
        size = input_var.shape[-1] if input_var.shape else 1
        b = self.create_parameter(
            ParamAttr._to_attr(True if bias_attr is True else bias_attr),
            shape=[size], dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(
            input_var.dtype, input_var.shape,
            lod_level=input_var.lod_level)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]},
                       attrs={"axis": input_var.shape and len(input_var.shape) - 1 or -1})
        return out

    def append_activation(self, input_var: Variable, act=None) -> Variable:
        act = self.kwargs.get("act", act)
        if act is None:
            return input_var
        act = {"type": act} if isinstance(act, str) else dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(
            input_var.dtype, input_var.shape,
            lod_level=input_var.lod_level)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out
