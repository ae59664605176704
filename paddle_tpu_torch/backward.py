"""append_backward: declare gradients for a loss (counterpart of
``paddle_tpu/backward.py``).

As in the JAX package, one ``backward`` pseudo-op is appended and the
gradient variables ``<param>@GRAD`` are declared so that fetches and
optimizer ops can name them.  At run time the Executor runs the forward
slice once under autograd and takes the gradients of the loss with
respect to the listed parameters (``core/executor.py``,
``_run_backward``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .core.program import Program, Variable, grad_var_name


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[set] = None,
                    callbacks=None) -> List[Tuple[Variable, Variable]]:
    """Returns [(parameter, gradient_var)] like fluid backward.py:257.

    The Rows feed of every ``lookup_table_sparse`` op (a host-resident
    sparse table, ``paddle_tpu_torch.sparse``) is a differentiable
    feed: its gradient is what the session pushes back to the host
    table, so the default wrt set (``parameter_list=None``) includes it
    though it is no Parameter.  An explicit ``parameter_list`` is the
    caller's exact wrt set, and a rows feed joins it only if named.
    Either way every rows var in the wrt set is tagged
    ``is_sparse_rows``, so the optimizer leaves it out of its clip,
    regularizer and update ops.  The discovery reads the ops, so it
    survives a JSON round trip of the program."""
    program: Program = loss.block.program
    block = program.global_block()
    no_grad = {n if isinstance(n, str) else n.name for n in (no_grad_set or ())}

    if parameter_list is not None:
        params = [block.var(p if isinstance(p, str) else p.name)
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters()
                  if getattr(p, "trainable", True)]
    params = [p for p in params if p.name not in no_grad]

    sparse_row_names = {n for b in program.blocks for op in b.ops
                        if op.type == "lookup_table_sparse"
                        for n in op.input("Rows")}
    for p in params:
        if p.name in sparse_row_names:
            p.is_sparse_rows = True
    if parameter_list is None:
        seen = {p.name for p in params}
        for n in sorted(sparse_row_names - no_grad - seen):
            v = block.var(n)
            v.is_sparse_rows = True
            params.append(v)
    if not params:
        raise ValueError("append_backward: no trainable parameters found")

    grad_vars = [block.create_var(name=grad_var_name(p.name), shape=p.shape,
                                  dtype=p.dtype, persistable=False,
                                  stop_gradient=True)
                 for p in params]
    block.append_op(
        type="backward",
        inputs={"Loss": [loss]},
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs={"loss": loss.name, "params": [p.name for p in params]},
    )
    return list(zip(params, grad_vars))


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients analog for a single scalar target."""
    t = targets[0] if isinstance(targets, (list, tuple)) else targets
    pairs = append_backward(t, parameter_list=[
        i.name if isinstance(i, Variable) else i
        for i in (inputs if isinstance(inputs, (list, tuple)) else [inputs])])
    return [g for _, g in pairs]
