"""Recurrent control flow (counterpart of ``rnn`` and
``rnn_memory_helper`` in ``paddle_tpu/ops/control_flow_ops.py:179-266``).

The ``rnn`` op is a ``StaticRNN``: a step sub-block run once per time
step.  The JAX package traces the step once and scans it with
``lax.scan``; the port interprets the step block in a child ``Env``
once per step in a Python loop, under autograd when the executor
differentiates, so the recurrence's gradient is autograd's.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .sequence_ops import _mask


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
# Static analysis: the memory helper is shape-preserving; ``rnn`` binds
# its outputs from its sub-block (SHAPE_INFER_ALLOWLIST) and has no shard
# rule (a blind spot, as in the JAX package).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import same_as  # noqa: E402
from ..analysis.shard_prop import shard_same_as  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)

register_shape_fn("rnn_memory_helper")(same_as("X"))
register_shard_fn("rnn_memory_helper")(shard_same_as("X"))
