"""Control-flow layers (counterpart of ``paddle_tpu/layers/control_flow.py``):
``While``, ``StaticRNN``, ``DynamicRNN``, ``IfElse``, ``Switch``,
``ConditionalBlock``, the tensor-array layers and the dynamic-RNN
plumbing.

``While`` and ``ConditionalBlock`` (and so ``Switch``) build ops whose
condition the port reads on the host: a program holding them runs
uncaptured (``ops/control_flow_ops.py``).  ``StaticRNN`` and
``DynamicRNN`` share the ``rnn`` op, which masks finished sequences
instead of shrinking the batch; ``IfElse`` computes both branches on
the whole batch and merges rows by the condition.  Programs built from
these, the arrays and the rank table stay captured."""
from __future__ import annotations

import contextlib

from ..core import unique_name
from ..layer_helper import LayerHelper

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "IfElse", "Switch", "increment",
    "less_than", "equal", "array_read", "array_write", "array_length",
    "create_array", "lod_rank_table", "max_sequence_len",
    "lod_tensor_to_array", "array_to_lod_tensor", "shrink_memory",
    "reorder_lod_tensor_by_rank", "ConditionalBlock",
]


def increment(x, value=1.0, in_place=True):
    """x + value, written back to ``x`` itself when ``in_place`` (the
    optimizers' ``global_step`` counter)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype, x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def _cmp(op, x, y, cond=None):
    helper = LayerHelper(op)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type=op, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    """x < y elementwise, a bool var."""
    return _cmp("less_than", x, y, cond)


def equal(x, y, cond=None):
    """x == y elementwise, a bool var."""
    return _cmp("equal", x, y, cond)


def _written_outside(sub):
    """The vars ``sub``'s ops write that an enclosing block declares, in
    the order first written: the carry of a loop, a branch's outputs."""
    written = []
    for op in sub.ops:
        for n in op.output_names:
            if n not in sub.vars and n not in written:
                written.append(n)
    return written


class While:
    """Loop while ``cond`` (a [1] bool var) is true::

        w = While(cond)
        with w.block():
            ...                              # ops of the body
            less_than(i, limit, cond=cond)   # recompute the condition

    The vars the body writes that are declared outside it are the loop's
    carry; they must have values before the loop.  The trip count is
    data, so the program runs uncaptured; reverse mode through the loop
    is refused, as in the JAX package."""

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.program = self.helper.main_program

    @contextlib.contextmanager
    def block(self):
        parent_block = self.program.current_block()
        sub = self.program.create_block()
        try:
            yield
        finally:
            written = _written_outside(sub)
            self.program.rollback()
            parent_block.append_op(
                "while",
                inputs={"Condition": [self.cond_var], "X": list(written)},
                outputs={"Out": written},
                attrs={"sub_block": sub.idx})


class ConditionalBlock:
    """Run a block iff ``inputs[0]`` (a [1] bool var) is true; the vars it
    writes keep their values otherwise (give them values first)."""

    def __init__(self, inputs, name=None):
        self.inputs = inputs
        self.helper = LayerHelper("conditional_block", name=name)
        self.program = self.helper.main_program

    @contextlib.contextmanager
    def block(self):
        parent_block = self.program.current_block()
        sub = self.program.create_block()
        try:
            yield
        finally:
            written = _written_outside(sub)
            self.program.rollback()
            parent_block.append_op(
                "conditional_block",
                inputs={"Cond": [self.inputs[0]]},
                outputs={"Out": written},
                attrs={"sub_block": sub.idx})


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


class DynamicRNN(StaticRNN):
    """fluid's DynamicRNN: a ``StaticRNN`` whose step is built under
    ``with drnn.block():``.  Lengths come from the inputs' ``@LEN``; a
    finished sequence's memories freeze."""

    @contextlib.contextmanager
    def block(self):
        with self.step():
            yield


class IfElse:
    """fluid's IfElse without partitioning the batch: both branches
    compute on every row, and ``ie()`` takes each output's row from the
    true branch where ``cond`` holds, else from the false branch (the
    same answer where the branches' ops are row-wise)::

        ie = IfElse(cond)                    # cond: [B, 1] bool
        with ie.true_block():
            ie.output(f(ie.input(x)))
        with ie.false_block():
            ie.output(g(ie.input(x)))
        out = ie()"""

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.in_true = True
        self.true_outs = []
        self.false_outs = []
        self.program = self.helper.main_program

    @contextlib.contextmanager
    def true_block(self):
        self.in_true = True
        yield

    @contextlib.contextmanager
    def false_block(self):
        self.in_true = False
        yield

    def input(self, x):
        return x

    def output(self, *outs):
        (self.true_outs if self.in_true else self.false_outs).extend(outs)

    def __call__(self):
        results = []
        for t, f in zip(self.true_outs, self.false_outs):
            helper = LayerHelper("ifelse_merge")
            out = helper.create_variable_for_type_inference(t.dtype, t.shape)
            helper.append_op(type="merge_lod_tensor",
                             inputs={"InTrue": [t], "InFalse": [f],
                                     "Mask": [self.cond]},
                             outputs={"Out": [out]})
            results.append(out)
        return results if len(results) > 1 else results[0]


class Switch:
    """fluid's Switch, as the JAX package builds it: each ``case`` is a
    ``ConditionalBlock`` of its own, so the cases are not exclusive (every
    true case runs, in order), and ``default()`` only yields, so its ops
    land in the enclosing block and run after every case (ROADMAP Queue
    C)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)

    @contextlib.contextmanager
    def case(self, condition):
        with ConditionalBlock([condition]).block():
            yield

    @contextlib.contextmanager
    def default(self):
        yield

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- tensor arrays and the rank table ----------------------------------------
def create_array(dtype):
    """A tensor-array var; its first ``array_write`` makes the buffer."""
    helper = LayerHelper("array")
    return helper.block.create_var(
        name=unique_name.generate("array"), dtype=dtype)


def array_write(x, i, array=None):
    """array[i] = x (a new array if none); returns the array."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    """array[i]."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    """The array's capacity (int64), not its count of writes."""
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def lod_rank_table(x, level=0):
    """x's rows in descending order of length (int32), the sorted
    lengths as its ``@LEN``."""
    helper = LayerHelper("lod_rank_table")
    out = helper.create_variable_for_type_inference("int32", lod_level=1)
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"level": level})
    return out


def max_sequence_len(rank_table):
    """The longest length of a rank table (int64)."""
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def lod_tensor_to_array(x, table):
    """[B, T, ...] -> a time-major [T, B, ...] array (the table is not
    read)."""
    helper = LayerHelper("lod_tensor_to_array")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def array_to_lod_tensor(x, table):
    """A time-major array back to [B, T, ...], with the table's lengths."""
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(x.dtype, lod_level=1)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def shrink_memory(x, i, table):
    """The identity (the RNN's mask freezes finished rows)."""
    helper = LayerHelper("shrink_memory")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """x's rows (and lengths) in the rank table's order."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape,
                                                    lod_level=x.lod_level)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out
