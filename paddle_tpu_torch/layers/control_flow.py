"""Control-flow layer functions (counterpart of ``increment``,
``less_than`` and ``StaticRNN`` in
``paddle_tpu/layers/control_flow.py``; ``While``,
``DynamicRNN`` and the conditionals come with the slices that use
them)."""
from __future__ import annotations

import contextlib

from ..core import unique_name
from ..layer_helper import LayerHelper

__all__ = ["increment", "less_than", "StaticRNN"]


def increment(x, value=1.0, in_place=True):
    """x + value, written back to ``x`` itself when ``in_place`` (the
    optimizers' ``global_step`` counter)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype, x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def less_than(x, y, cond=None):
    """x < y elementwise, a bool var."""
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


class StaticRNN:
    """An RNN over the time dim of padded sequences, built as a step
    sub-block (``control_flow.py:130-227`` of the JAX package)::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # [B, T, ...] -> [B, ...]
            h = rnn.memory(init=h0)
            h_new = ...                      # ops of the step block
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        out = rnn()                          # [B, T, ...]

    Leaving ``step()`` appends one ``rnn`` op to the parent block
    (``ops/control_flow_ops.py``), which runs the step once per time
    step with rows past their length frozen."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.program = self.helper.main_program
        self.seq_len_var = None
        self.inputs = []          # (x var, step var name)
        self.memories = {}        # step name -> [init var, new name]
        self.step_outputs = []
        self.sub_block = None
        self.status = self.BEFORE_RNN_BLOCK
        self.parent_block = None

    def _in_step(self, what):
        if self.status != self.IN_RNN_BLOCK:
            raise RuntimeError(f"StaticRNN.{what} must be called inside "
                               f"`with rnn.step():`")

    @contextlib.contextmanager
    def step(self):
        self.status = self.IN_RNN_BLOCK
        self.parent_block = self.program.current_block()
        self.sub_block = self.program.create_block()
        try:
            yield
        finally:
            self.program.rollback()
            self.status = self.AFTER_RNN_BLOCK
            self._complete()

    def step_input(self, x):
        """x: a [B, T, ...] sequence var; returns its per-step [B, ...]
        slice.  The first step input's lengths mask the whole RNN."""
        self._in_step("step_input")
        ipt = self.sub_block.create_var(
            name=unique_name.generate("rnn_step_in"), dtype=x.dtype,
            shape=(x.shape[0],) + tuple(x.shape[2:]) if x.shape else None)
        self.inputs.append((x, ipt.name))
        if self.seq_len_var is None:
            self.seq_len_var = x
        return ipt

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype="float32"):
        """A state carried across steps, started from ``init`` or, with
        none, from ``value`` in ``[batch] + shape`` (batch taken from
        ``batch_ref`` or the first step input)."""
        self._in_step("memory")
        if init is None:
            from . import tensor
            cur = self.program.current_block_idx
            self.program.current_block_idx = self.parent_block.idx
            try:
                init = tensor.fill_constant_batch_size_like(
                    batch_ref or self.seq_len_var,
                    [-1] + list(shape), dtype, value)
            finally:
                self.program.current_block_idx = cur
        mem = self.sub_block.create_var(
            name=unique_name.generate("rnn_mem"), dtype=init.dtype,
            shape=init.shape)
        self.memories[mem.name] = [init, None]
        return mem

    def update_memory(self, mem, new):
        self.memories[mem.name][1] = new.name

    def step_output(self, o):
        self._in_step("step_output")
        self.step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        self.outputs = [
            self.parent_block.create_var(
                name=unique_name.generate("rnn_out"), dtype=o.dtype,
                shape=(o.shape[0], -1) + tuple(o.shape[1:]) if o.shape
                else None, lod_level=1)
            for o in self.step_outputs]
        mem_names = list(self.memories)
        self.parent_block.append_op(
            "rnn",
            inputs={"Inputs": [x.name for x, _ in self.inputs],
                    "InitStates": [self.memories[m][0].name
                                   for m in mem_names]},
            outputs={"Outputs": [v.name for v in self.outputs]},
            attrs={
                "sub_block": self.sub_block.idx,
                "step_inputs": [n for _, n in self.inputs],
                "mem_step_names": mem_names,
                "mem_update_names": [self.memories[m][1] for m in mem_names],
                "step_output_names": [o.name for o in self.step_outputs],
            })

    def __call__(self):
        return self.outputs if len(self.outputs) > 1 else self.outputs[0]
