"""Control flow (counterpart of ``paddle_tpu/ops/control_flow_ops.py``:
``while``, ``conditional_block``, the IfElse split and merge, the
tensor arrays, the rank table, the dynamic-RNN plumbing, ``rnn``,
``print`` and ``assert``).

The JAX package lowers ``while`` to ``lax.while_loop`` and
``conditional_block`` to ``lax.cond``, compiled control flow with no
host round trip.  A CUDA graph cannot hold a loop whose trip count is
data nor a branch chosen by a value, so the port reads the condition on
the host: ``while`` interprets its body block in a child ``Env`` until
the condition is false, and ``conditional_block`` runs its block only
when the predicate is true.  The executor sees these ops (and
``print``, which must print at every run) before a step is captured
and runs such a program uncaptured, counted under the op's name
(``core/executor.py``, ``UNCAPTURED_OPS``).

Everything else keeps the JAX package's static shapes, so a CUDA graph
holds it: IfElse computes both branches on the whole batch and merges
rows with a mask; a tensor array is a ``[capacity, ...]`` buffer written
and read at a tensor index (a negative index counts from the end, and
the index is clamped into the buffer, as ``lax.dynamic_update_slice``
does); ``lod_array_length`` is that capacity; ``lod_tensor_to_array``
and ``array_to_lod_tensor`` swap the batch and time dims.

The ``rnn`` op is a ``StaticRNN``: a step sub-block run once per time
step.  The JAX package traces the step once and scans it with
``lax.scan``; the port interprets the step block in a child ``Env``
once per step in a Python loop, under autograd when the executor
differentiates, so the recurrence's gradient is autograd's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from .sequence_ops import _mask


def _host_bool(v) -> bool:
    """The [1] (or scalar) predicate ``v`` read on the host."""
    return bool(v.reshape(()).item())


@register_op("while")
def _while(ctx, ins, attrs):
    """attrs: sub_block.  inputs: Condition ([1] bool), X (the loop vars
    read).  outputs: Out (the parent's vars the body writes: the loop
    carry).  The body must recompute Condition.

    Reverse mode through the loop is refused, as ``lax.while_loop``
    refuses it: a carry that depends on a differentiated value raises."""
    sub_idx = attrs["sub_block"]
    cond_name = ctx.op.inputs["Condition"][0]
    carry_names = list(ctx.op.outputs["Out"])
    env = ctx.env
    vals = {n: env.get(n) for n in carry_names}
    cond = env.get(cond_name)
    while _host_bool(cond):
        benv = ctx.child_env(sub_idx, env)
        # the carried vars shadow the parent's: the body's writes stay in
        # the child env until the loop ends
        benv.local.update(vals)
        ctx.interpret_block(sub_idx, benv)
        vals = {n: benv.get(n) for n in carry_names}
        cond = benv.get(cond_name)
    bad = [n for n, v in vals.items()
           if isinstance(v, torch.Tensor) and v.requires_grad]
    if bad and torch.is_grad_enabled():
        raise ValueError(
            f"while: reverse-mode differentiation through a while loop is "
            f"not supported (its trip count is data; lax.while_loop refuses "
            f"it too): the carried vars {bad} depend on a differentiated "
            f"value")
    return {"Out": [vals[n] for n in carry_names]}


@register_op("conditional_block")
def _conditional_block(ctx, ins, attrs):
    """Run the sub-block iff Cond is true; else the outputs keep their
    current values (they must have values already: fill_constant them).
    Only the branch taken runs, so only it is differentiated."""
    sub_idx = attrs["sub_block"]
    out_names = list(ctx.op.outputs.get("Out", []))
    env = ctx.env
    current = [env.get(n) for n in out_names]
    if not _host_bool(ins["Cond"][0]):
        return {"Out": current}
    benv = ctx.child_env(sub_idx, env)
    ctx.interpret_block(sub_idx, benv)
    return {"Out": [benv.get(n) for n in out_names]}


@register_op("split_lod_tensor")
def _split_lod_tensor(ctx, ins, attrs):
    """IfElse's entry: both branches get the whole tensor (the mask
    rides along to ``merge_lod_tensor``)."""
    x = ins["X"][0]
    return {"OutTrue": x, "OutFalse": x}


@register_op("merge_lod_tensor")
def _merge_lod_tensor(ctx, ins, attrs):
    """Row i of InTrue where Mask[i], else of InFalse."""
    x_true, x_false, mask = ins["InTrue"][0], ins["InFalse"][0], \
        ins["Mask"][0]
    m = mask.reshape((-1,) + (1,) * (x_true.dim() - 1)).bool()
    return {"Out": torch.where(m, x_true, x_false)}


# ---------------------------------------------------------------------------
# tensor arrays: a [capacity, ...] buffer
# ---------------------------------------------------------------------------
def _array_index(i, cap):
    """The scalar index tensor ``i`` as ``lax.dynamic_*_slice`` reads it:
    negative counts from the end, then clamped into [0, cap - 1]; [1]
    int64, on the device (no host read)."""
    i = i.reshape(1).long()
    return torch.where(i < 0, i + cap, i).clamp(0, cap - 1)


@register_op("write_to_array")
def _write_to_array(ctx, ins, attrs):
    """array[i] = x; the buffer is made [capacity, ...] of zeros at the
    first write (attr ``capacity``, default 128)."""
    x = ins["X"][0]
    out_name = ctx.op.outputs["Out"][0]
    if ctx.env.has(out_name):
        buf = ctx.env.get(out_name)
    else:
        cap = int(attrs.get("capacity", 128))
        buf = torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    return {"Out": buf.index_copy(0, _array_index(ins["I"][0],
                                                  buf.shape[0]), x[None])}


@register_op("read_from_array")
def _read_from_array(ctx, ins, attrs):
    buf = ins["X"][0]
    return {"Out": buf.index_select(
        0, _array_index(ins["I"][0], buf.shape[0]))[0]}


@register_op("lod_array_length")
def _lod_array_length(ctx, ins, attrs):
    """The buffer's capacity, not the count of writes, as in the JAX
    package (int64; int32 there without x64)."""
    buf = ins["X"][0]
    return {"Out": torch.full((), buf.shape[0], dtype=torch.int64,
                              device=buf.device)}


@register_op("lod_tensor_to_array")
def _lod_tensor_to_array(ctx, ins, attrs):
    """[B, T, ...] -> the time-major [T, B, ...] buffer; the rank table
    is not read (the reference builds per-step shrinking batches)."""
    return {"Out": ins["X"][0].transpose(0, 1)}


@register_op("array_to_lod_tensor")
def _array_to_lod_tensor(ctx, ins, attrs):
    """[T, B, ...] -> [B, T, ...], with the rank table's lengths as the
    output's ``@LEN``."""
    out = ins["X"][0].transpose(0, 1)
    rt = ctx.op.inputs.get("RankTable")
    if rt:
        lens = ctx.get_len(rt[0])
        if lens is not None:
            ctx.set_len(ctx.op.outputs["Out"][0], lens)
    return {"Out": out}


@register_op("lod_rank_table")
def _lod_rank_table(ctx, ins, attrs):
    """The rows in descending order of length (stable: equal lengths keep
    their order), int32 [B]; its ``@LEN`` is the sorted lengths.  A var
    without lengths counts every row as T long."""
    x = ins["X"][0]
    lens = ctx.get_len(ctx.op.inputs["X"][0])
    if lens is None:
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    order = torch.argsort(-lens, stable=True)
    ctx.set_len(ctx.op.outputs["Out"][0], lens[order])
    return {"Out": order.int()}


@register_op("reorder_lod_tensor_by_rank")
def _reorder_by_rank(ctx, ins, attrs):
    """X's rows (and lengths) in the rank table's order."""
    x, rank = ins["X"][0], ins["RankTable"][0].long()
    lens = ctx.get_len(ctx.op.inputs["X"][0])
    if lens is not None:
        ctx.set_len(ctx.op.outputs["Out"][0], lens[rank])
    return {"Out": x[rank]}


@register_op("shrink_rnn_memory")
def _shrink_rnn_memory(ctx, ins, attrs):
    """The identity: rows whose sequence ended are frozen by the RNN's
    mask instead of dropped from the batch."""
    return {"Out": ins["X"][0]}


@register_op("print")
def _print(ctx, ins, attrs):
    """Print ``message`` and the value at every run (inside a ``while``
    at every iteration), as ``jax.debug.print(message + " {x}")``."""
    x = ins.get("In", ins.get("X", [None]))[0]
    v = x.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    print(attrs.get("message", "") + " " + str(np.asarray(v.cpu())))
    return {"Out": x} if ctx.op.outputs.get("Out") else {}


@register_op("assert")
def _assert(ctx, ins, attrs):
    return {}


@register_op("rnn_memory_helper")
def _rnn_memory_helper(ctx, ins, attrs):
    return {"Out": ins["X"][0]}


@register_op("rnn")
def _rnn(ctx, ins, attrs):
    """Step the ``sub_block`` over T: Inputs [B, T, ...] are sliced into
    the ``step_inputs`` vars, the ``mem_step_names`` vars hold the
    memories (started from InitStates), and each step's
    ``step_output_names`` stack into Outputs [B, T, ...].

    A row whose sequence has ended (t >= its length, from the first
    input that has an ``@LEN``) keeps its memories and outputs zeros;
    each output carries those lengths as its ``@LEN``.  A nested input
    (an ``@LEN2`` companion [B, S]) hands each step its slice's inner
    lengths as the step var's ``@LEN``; an output stacked from a step
    var that is itself a sequence carries the ``@LEN2`` on."""
    sub_idx = attrs["sub_block"]
    step_in_names = attrs["step_inputs"]
    mem_names = attrs["mem_step_names"]
    mem_update_names = attrs["mem_update_names"]
    out_step_names = attrs["step_output_names"]
    seqs = ins.get("Inputs", [])
    mems = list(ins.get("InitStates", []))
    env = ctx.env
    B, T = seqs[0].shape[0], seqs[0].shape[1]
    seq_parent_names = ctx.op.inputs.get("Inputs", [])
    lens = next((ln for ln in map(ctx.get_len, seq_parent_names)
                 if ln is not None), None)
    if lens is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=seqs[0].device)
    mask = _mask(lens, T, seqs[0].dtype)                 # [B, T]
    nested = [(step_nm, l2) for step_nm, l2 in
              ((s, ctx.get_len2(p))
               for s, p in zip(step_in_names, seq_parent_names))
              if l2 is not None]

    def rows(m_t, v):
        return m_t.reshape((B,) + (1,) * (v.dim() - 1))

    outs = [[] for _ in out_step_names]
    for t in range(T):
        m_t = mask[:, t]
        benv = ctx.child_env(sub_idx, env)
        for nm, s in zip(step_in_names, seqs):
            benv.local[nm] = s[:, t]
        for nm, l2 in nested:
            benv.local[nm + "@LEN"] = l2[:, t]
        for nm, v in zip(mem_names, mems):
            benv.local[nm] = v
        ctx.interpret_block(sub_idx, benv)
        mems = [torch.where(rows(m_t, old) > 0, benv.get(un), old)
                if un else old
                for un, old in zip(mem_update_names, mems)]
        for acc, nm in zip(outs, out_step_names):
            v = benv.get(nm)
            acc.append(v * rows(m_t, v))
    results = [torch.stack(acc, dim=1) for acc in outs]
    sub_vars = ctx.block(sub_idx).vars
    for nm, step_nm in zip(ctx.op.outputs.get("Outputs", []),
                           out_step_names):
        ctx.set_len(nm, lens)
        # per-step vectors stack to [B, S, H] and carry no @LEN2; only a
        # step output that is itself a sequence makes a nested output
        sv = sub_vars.get(step_nm)
        if nested and sv is not None and sv.lod_level >= 1:
            ctx.set_len2(nm, nested[0][1])
    return {"Outputs": results}


# ---------------------------------------------------------------------------
# Static analysis (the JAX package's rules): ``while``,
# ``conditional_block``, ``write_to_array`` and ``rnn`` bind their outputs
# from their sub-blocks or the env (SHAPE_INFER_ALLOWLIST); the memory
# helpers are shape-preserving, print and assert transparent; the array
# and rank-table ops have no shard rule (a blind spot, as in the JAX
# package).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (VarInfo, first, no_outputs,  # noqa: E402
                                    passthrough, same_as)
from ..analysis.shard_prop import shard_noop, shard_same_as  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)

register_shape_fn("shrink_rnn_memory", "rnn_memory_helper")(same_as("X"))
register_shape_fn("split_lod_tensor")(
    same_as("X", out="OutTrue", also=("OutFalse",)))
register_shape_fn("merge_lod_tensor")(same_as("InTrue"))
register_shape_fn("reorder_lod_tensor_by_rank")(same_as("X"))
register_shape_fn("print")(passthrough("In", "X"))
register_shape_fn("assert")(no_outputs())


@register_shape_fn("read_from_array")
def _read_from_array_shape(op, ins, attrs):
    buf = first(ins, "X")
    if buf.shape is None:
        return {"Out": buf}
    return {"Out": buf.with_shape(buf.shape[1:])}


@register_shape_fn("lod_array_length")
def _lod_array_length_shape(op, ins, attrs):
    return {"Out": VarInfo((), "int64")}


@register_shape_fn("lod_tensor_to_array", "array_to_lod_tensor")
def _swap01_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None or len(x.shape) < 2:
        return {"Out": VarInfo(None, x.dtype)}
    return {"Out": x.with_shape((x.shape[1], x.shape[0]) + x.shape[2:])}


@register_shape_fn("lod_rank_table")
def _lod_rank_table_shape(op, ins, attrs):
    x = first(ins, "X")
    b = x.shape[0] if x.shape is not None else -1
    return {"Out": VarInfo((b,), "int32")}


register_shard_fn("shrink_rnn_memory", "rnn_memory_helper")(
    shard_same_as("X"))
register_shard_fn("print", "assert")(shard_noop())
