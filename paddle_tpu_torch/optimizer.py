"""Optimizer builders: append backward + optimizer ops to the program
(counterpart of ``paddle_tpu/optimizer.py``; reference:
fluid/optimizer.py:190 minimize and its optimizers).

The program's optimizer section is plain ops, run by the Executor after
the ``backward`` pseudo-op: SGD, Momentum, Adagrad, Adam, Adamax,
DecayedAdagrad, Adadelta, RMSProp and Ftrl, each with the JAX
package's accumulators under the same names, so a scope (or a
checkpoint) carries across.  A learning rate may be a number or a
Variable, such as one of ``lr_decay``'s schedules.  ``ModelAverage``
averages the parameters on the host; ``StaticPruningHook`` re-applies
magnitude masks in the step, after the update.
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
           "AdagradOptimizer", "AdamOptimizer", "AdamaxOptimizer",
           "DecayedAdagradOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "SGD", "Momentum",
           "Adagrad", "Adam", "Adamax", "DecayedAdagrad", "Adadelta",
           "RMSProp", "Ftrl", "ModelAverage", "StaticPruningHook",
           "exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay"]


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
            # a host-resident sparse table's rows feed gets its gradient
            # from append_backward but no optimizer op, clip or
            # regularizer: the SparseSession updates the rows on the host
            host_pairs = [(p, g) for p, g in params_grads
                          if getattr(p, "is_sparse_rows", False)]
            dev_pairs = [(p, g) for p, g in params_grads
                         if not getattr(p, "is_sparse_rows", False)]
            dev_pairs = append_gradient_clip_ops(dev_pairs)
            dev_pairs = append_regularization_ops(dev_pairs,
                                                  self.regularization)
            optimize_ops = self.apply_gradients(dev_pairs, program)
            params_grads = dev_pairs + host_pairs
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
    a scope carries across.  ``lazy_mode`` (the reference's attr): a
    parameter that only ``lookup_table`` ops read (an embedding table)
    updates just the rows the batch looked up; untouched rows keep
    stale moments, as in the reference's sparse path."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, self._beta1, shape=[1])
            self._add_accumulator("beta2_pow", p, self._beta2, shape=[1])

    @staticmethod
    def _lookup_ids(program, param):
        """Ids vars of every lookup_table reading ``param``; None when
        another op reads it too (the dense update is needed)."""
        ids, other_use = [], False
        for block in program.blocks:
            for op in block.ops:
                if param.name not in op.input_names:
                    continue
                if op.type == "lookup_table":
                    ids.extend(op.inputs.get("Ids", []))
                else:
                    other_use = True
        return None if (other_use or not ids) else ids

    def _append_optimize_op(self, program, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1 = self._get_accumulator("beta1_pow", param)
        b2 = self._get_accumulator("beta2_pow", param)
        inputs = {"Param": [param], "Grad": [grad], "Moment1": [m1],
                  "Moment2": [m2], "Beta1Pow": [b1], "Beta2Pow": [b2],
                  "LearningRate": [self._lr_for_param(param)]}
        attrs = {"beta1": self._beta1, "beta2": self._beta2,
                 "epsilon": self._epsilon}
        if self._lazy_mode:
            ids = self._lookup_ids(program, param)
            if ids is not None:
                inputs["Rows"] = ids
                attrs["lazy_mode"] = True
        return program.global_block().append_op(
            "adam", inputs=inputs,
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1.name],
                     "Beta2PowOut": [b2.name]},
            attrs=attrs)


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, program, param, grad):
        m = self._get_accumulator("moment", param)
        return program.global_block().append_op(
            "adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, self._beta1, shape=[1])

    def _append_optimize_op(self, program, param, grad):
        m = self._get_accumulator("moment", param)
        inf = self._get_accumulator("inf_norm", param)
        b1 = self._get_accumulator("beta1_pow", param)
        return program.global_block().append_op(
            "adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "InfNorm": [inf], "Beta1Pow": [b1],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name], "MomentOut": [m.name],
                     "InfNormOut": [inf.name], "Beta1PowOut": [b1.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, program, param, grad):
        m = self._get_accumulator("moment", param)
        return program.global_block().append_op(
            "decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, program, param, grad):
        g2 = self._get_accumulator("avg_squared_grad", param)
        u2 = self._get_accumulator("avg_squared_update", param)
        return program.global_block().append_op(
            "adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [g2], "AvgSquaredUpdate": [u2],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name],
                     "AvgSquaredGradOut": [g2.name],
                     "AvgSquaredUpdateOut": [u2.name]},
            attrs={"rho": self._rho, "epsilon": self._epsilon})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, program, param, grad):
        ms = self._get_accumulator("mean_square", param)
        mom = self._get_accumulator("momentum", param)
        return program.global_block().append_op(
            "rmsprop",
            inputs={"Param": [param], "Grad": [grad], "MeanSquare": [ms],
                    "Moment": [mom],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name], "MeanSquareOut": [ms.name],
                     "MomentOut": [mom.name]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, program, param, grad):
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return program.global_block().append_op(
            "ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._lr_for_param(param)]},
            outputs={"ParamOut": [param.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer

# the schedules, re-exported for the fluid surface
from .lr_decay import (exponential_decay, natural_exp_decay,  # noqa: E402
                       inverse_time_decay, polynomial_decay,
                       piecewise_decay, noam_decay)


def _on_device_of(value, like):
    """``value`` (numpy) as a tensor where ``like`` lives, in its dtype."""
    import torch
    return torch.as_tensor(value).to(device=like.device, dtype=like.dtype)


class ModelAverage:
    """Sliding-window parameter averaging (counterpart of
    ``paddle_tpu/optimizer.py:363-450``; reference: fluid
    optimizer.ModelAverage).

    A host-side accumulator over the trainable fp32 parameters: call
    ``update()`` once a step after ``Executor.run``, and evaluate under
    ``apply()``, which swaps the averaged weights into the scope and
    restores the trained ones on exit::

        ma = ModelAverage(average_window_rate=0.5)
        for step in ...:
            exe.run(...)
            ma.update()
        with ma.apply():
            test_loss = exe.run(test_program, ...)

    The window grows with training up to ``max_average_window`` steps.
    A captured step sees the swap: before a replay it copies in every
    scope tensor that is not its own buffer.
    """

    def __init__(self, average_window_rate=0.5, min_average_window=2,
                 max_average_window=10000, scope=None, var_names=None):
        from .core.scope import global_scope
        self.rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window
        self._scope = scope or global_scope()
        self._names = var_names
        self._avg = {}
        self._steps = 0
        self._backup = None

    def _tracked(self):
        if self._names is None:
            # parameters only (not accumulators or learning rates), their
            # dtype read off the tensor without a copy to the host
            import torch
            from .core.program import default_main_program
            params = {p.name for p in
                      default_main_program().global_block().all_parameters()}
            self._names = [
                n for n in self._scope.keys()
                if n in params and
                getattr(self._scope.get(n), "dtype", None) == torch.float32]
        return self._names

    def update(self):
        import numpy as np
        from .core.scope import to_numpy
        self._steps += 1
        window = min(self._steps,
                     max(self.min_window,
                         int(self.rate * min(self._steps,
                                             self.max_window)) or 1))
        for n in self._tracked():
            v = np.asarray(to_numpy(self._scope.get(n)), dtype=np.float32)
            if n not in self._avg:
                self._avg[n] = v.copy()
            else:
                self._avg[n] += (v - self._avg[n]) / window

    def apply(self):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            from .core.scope import to_numpy
            self._backup = {n: to_numpy(self._scope.get(n)).copy()
                            for n in self._avg}
            for n, v in self._avg.items():
                self._scope.set(n, _on_device_of(v, self._scope.get(n)))
            try:
                yield self
            finally:
                self.restore()
        return _ctx()

    def restore(self):
        if self._backup is None:
            return
        for n, v in self._backup.items():
            self._scope.set(n, _on_device_of(v, self._scope.get(n)))
        self._backup = None


class StaticPruningHook:
    """Magnitude pruning masks re-applied every step (counterpart of
    ``paddle_tpu/optimizer.py:451-512``; reference:
    ParameterUpdaterHook.cpp:39 StaticPruningHook).

    The mask of each parameter is a persistable var of the scope, and the
    re-masking an ``elementwise_mul`` appended after the optimizer's
    update, so it runs inside the step::

        ptt.optimizer.Momentum(...).minimize(loss)
        hook = StaticPruningHook(sparsity_ratio=0.8)
        hook.attach(["fc_0.w_0"])          # ops, before the startup run
        exe.run(startup)
        hook.initialize()                  # masks from the initial |w|
    """

    def __init__(self, sparsity_ratio=0.8):
        self.sparsity_ratio = sparsity_ratio
        self._masked = []       # (param name, mask name)

    def attach(self, param_names, main_program=None, startup_program=None):
        from .core.program import default_main_program
        prog = main_program or default_main_program()
        block = prog.global_block()
        for pname in param_names:
            mname = f"{pname}@PRUNE_MASK"
            p = block.var(pname)
            block.create_var(name=mname, shape=p.shape, dtype=p.dtype,
                             persistable=True, stop_gradient=True)
            block.append_op(
                "elementwise_mul",
                inputs={"X": [pname], "Y": [mname]},
                outputs={"Out": [pname]}, attrs={"axis": -1})
            self._masked.append((pname, mname))
        return self

    def initialize(self, scope=None):
        """Masks from the current weight magnitudes (once, after the
        startup program ran): the smallest ``sparsity_ratio`` fraction by
        |w| is pinned to zero."""
        import numpy as np
        from .core.scope import global_scope, to_numpy
        scope = scope or global_scope()
        for pname, mname in self._masked:
            t = scope.get(pname)
            w = to_numpy(t)
            k = int(self.sparsity_ratio * w.size)
            mask = np.ones(w.size, w.dtype)
            if k > 0:
                idx = np.argsort(np.abs(w).ravel())[:k]
                mask[idx] = 0.0
            scope.set(mname, _on_device_of(mask.reshape(w.shape), t))

    def sparsity(self, pname, scope=None):
        from .core.scope import global_scope, to_numpy
        scope = scope or global_scope()
        return float((to_numpy(scope.get(pname)) == 0).mean())
