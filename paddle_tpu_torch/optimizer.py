"""Optimizer builders: append backward + optimizer ops to the program
(counterpart of ``paddle_tpu/optimizer.py``; reference:
fluid/optimizer.py:190 minimize, SGD, Momentum and Adam).

The program's optimizer section is plain ops, run by the Executor after
the ``backward`` pseudo-op.  Adagrad and the others come with the
slices that use them.
"""
from __future__ import annotations

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .core import unique_name
from .core.program import Parameter, Program, Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer", "SGD", "Momentum", "Adam"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None,
                 global_step=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._global_step = global_step
        self._name = name
        self._accumulators = {}       # name -> {param_name: var}
        self._lr_var = None

    # -- learning rate -----------------------------------------------------
    def _create_lr_var(self, program: Program):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        helper = LayerHelper("learning_rate")
        name = unique_name.generate("learning_rate")
        var = helper.create_global_variable([1], "float32", name=name)
        helper.set_variable_initializer(
            var, ConstantInitializer(float(self._learning_rate)))
        self._lr_var = var

    def _lr_for_param(self, param: Parameter):
        mult = 1.0
        if getattr(param, "optimize_attr", None):
            mult = param.optimize_attr.get("learning_rate", 1.0)
        if mult == 1.0:
            return self._lr_var
        from . import layers
        return layers.scale(self._lr_var, scale=mult)

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None):
        helper = LayerHelper(f"{name}_acc")
        shape = shape if shape is not None else list(param.shape)
        var = helper.create_global_variable(
            shape, param.dtype,
            name=unique_name.generate(f"{param.name}_{name}"))
        helper.set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- main entry --------------------------------------------------------
    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        from .core.program import program_guard
        program = loss.block.program
        # LayerHelper-built pieces (clip graphs, lr vars, accumulators) must
        # land in the LOSS's program even if a different default is active
        with program_guard(program, startup_program):
            params_grads = append_backward(loss, parameter_list, no_grad_set)
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            optimize_ops = self.apply_gradients(params_grads, program)
        return optimize_ops, params_grads

    def apply_gradients(self, params_grads, program=None):
        program = program or default_main_program()
        self._create_lr_var(program)
        self._create_accumulators(program, [p for p, _ in params_grads])
        ops = [self._append_optimize_op(program, p, g)
               for p, g in params_grads]
        if self._global_step is not None:
            from . import layers
            layers.increment(self._global_step, 1.0, in_place=True)
        return ops

    # -- per-optimizer hooks ----------------------------------------------
    def _create_accumulators(self, program, params):
        pass

    def _append_optimize_op(self, program, param, grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, program, param, grad):
        return program.global_block().append_op(
            "sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, program, param, grad):
        v = self._get_accumulator("velocity", param)
        return program.global_block().append_op(
            "momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [v],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    """Adam as an op (adam_op.cc), with the JAX package's accumulators:
    ``moment1``, ``moment2`` (zeros) and ``beta1_pow``, ``beta2_pow``
    ([1], starting at beta1 and beta2), named ``<param>_<acc>_<n>``, so
    a scope carries across.  The JAX optimizer's ``lazy_mode`` (rows of
    the batch only) comes with the sparse slice."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        if lazy_mode:
            raise NotImplementedError(
                "AdamOptimizer(lazy_mode=True) is not ported yet; it comes "
                "with the sparse slice")
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, self._beta1, shape=[1])
            self._add_accumulator("beta2_pow", p, self._beta2, shape=[1])

    def _append_optimize_op(self, program, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1 = self._get_accumulator("beta1_pow", param)
        b2 = self._get_accumulator("beta2_pow", param)
        return program.global_block().append_op(
            "adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1], "Beta2Pow": [b2],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1.name],
                     "Beta2PowOut": [b2.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
