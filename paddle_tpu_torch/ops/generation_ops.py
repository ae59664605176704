"""Beam search (counterpart of ``beam_search``, ``beam_search_decode`` and
the ``recurrent`` alias in ``paddle_tpu/ops/generation_ops.py:15-144``;
see ``layers/generation.py`` for the decoder that builds the op).

The JAX lowering scans the step sub-block with ``lax.scan`` over
``max_len`` steps; the port interprets it in a child ``Env`` once per
step in a Python loop, so a captured graph or an exported one holds the
loop unrolled.  Everything the scan does is kept: memories and contexts
repeated K times, only beam 0 expanded at step 0, finished beams frozen
on a virtual eos, the step hook's bias, memories regathered by parent,
the backtrace, the eos mask and the length penalty.

Ties.  ``lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order among ties.  :func:`top_k` ranks a
64-bit key instead, the float's order-preserving bits above the
complement of its index, so the K largest come out sorted by value and,
among equal values, by index: the same rule on the CPU and on a card.
``attention_with_cache`` comes with ``serving/decode.py``.
"""
from __future__ import annotations

import torch

from ..core.registry import get_op_impl, register_op

NEG_INF = -1e30
_LOW = (1 << 32) - 1


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest of each row of ``x``
    (float32 [..., N], N < 2^32), sorted descending, equal values in
    ascending index order, as ``lax.top_k``."""
    bits = x.contiguous().view(torch.int32)
    # negative floats order backwards as integers: flip all but the sign
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    key = order * (1 << 32) + (_LOW - idx)
    top = torch.topk(key, k, dim=-1).values
    index = _LOW - (top & _LOW)
    return torch.gather(x, -1, index), index


def _repeat_rows(v: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.repeat(v, k, axis=0)``: each row k times in a row."""
    B = v.shape[0]
    return v.unsqueeze(1).expand((B, k) + tuple(v.shape[1:])).reshape(
        (B * k,) + tuple(v.shape[1:]))


@register_op("beam_search")
def _beam_search(ctx, ins, attrs):
    sub_idx = attrs["sub_block"]
    token_name = attrs["token_name"]
    probs_name = attrs["probs_name"]
    mem_names = attrs["mem_step_names"]
    mem_update_names = attrs["mem_update_names"]
    ctx_names = attrs.get("ctx_step_names", [])
    K = int(attrs["beam_size"])
    bos = int(attrs["bos_id"])
    eos = int(attrs["eos_id"])
    T = int(attrs["max_len"])
    V = int(attrs["vocab_size"])
    lp = float(attrs.get("length_penalty", 0.0))
    hook = None
    if attrs.get("step_hook"):
        from ..layers.generation import get_beam_hook
        hook = get_beam_hook(attrs["step_hook"])

    init_in = ins.get("InitStates", [])
    ctx_in = ins.get("Contexts", [])
    # the batch from whichever input exists: a decoder without memories
    # has no InitStates
    if init_in:
        ref = init_in[0]
    elif ctx_in:
        ref = ctx_in[0]
    else:
        raise ValueError(
            "beam_search: cannot infer batch size — decoder registered "
            "neither memories (InitStates) nor context inputs (Contexts); "
            "pass at least one non-step input to BeamSearchDecoder")
    B, dev = ref.shape[0], ref.device
    mems = [_repeat_rows(v, K) for v in init_in]
    ctxs = [_repeat_rows(v, K) for v in ctx_in]
    env = ctx.env

    tokens = torch.full((B, K), bos, dtype=torch.int32, device=dev)
    cum = torch.zeros((B, K), dtype=torch.float32, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    flens = torch.zeros((B, K), dtype=torch.int32, device=dev)
    # a finished beam continues only with a virtual eos of probability 1
    frozen = torch.where(torch.arange(V, device=dev) == eos, 0.0, NEG_INF)
    # step 0: the K beams are copies of bos; only beam 0 expands
    dup = torch.where(torch.arange(K, device=dev) > 0, NEG_INF, 0.0)
    rows = torch.arange(B, device=dev)[:, None] * K
    tok_tab, par_tab = [], []
    for t in range(T):
        benv = ctx.child_env(sub_idx, env)
        benv.local[token_name] = tokens.reshape(-1)
        for nm, v in zip(mem_names, mems):
            benv.local[nm] = v
        for nm, v in zip(ctx_names, ctxs):
            benv.local[nm] = v
        ctx.interpret_block(sub_idx, benv)
        probs = benv.get(probs_name)
        new_mems = [benv.get(un) if un else old
                    for un, old in zip(mem_update_names, mems)]
        logp = torch.log(torch.clamp_min(probs, 1e-20)).reshape(
            B, K, V)
        logp = torch.where(finished[..., None], frozen, logp)
        total = cum[..., None] + logp                      # [B, K, V]
        if hook is not None:
            bias = hook(t, {"scores": total, "tokens": tokens,
                            "finished": finished})
            if bias is not None:
                total = total + bias
        if t == 0:
            total = total + dup[None, :, None]
        cum, top_idx = top_k(total.reshape(B, K * V), K)     # [B, K]
        parent = torch.div(top_idx, V, rounding_mode="floor")
        token = (top_idx - parent * V).to(torch.int32)
        was_finished = torch.gather(finished, 1, parent)
        finished = was_finished | (token == eos)
        prev = torch.gather(flens, 1, parent)
        flens = torch.where(was_finished, prev, prev + 1)
        flat_parent = (rows + parent).reshape(-1)
        mems = [m[flat_parent] for m in new_mems]
        tokens = token
        tok_tab.append(token)
        par_tab.append(parent)
    # backtrace from the final beams
    beam = torch.arange(K, device=dev)[None, :].expand(B, K)
    rev = []
    for t in range(T - 1, -1, -1):
        rev.append(torch.gather(tok_tab[t], 1, beam))
        beam = torch.gather(par_tab[t], 1, beam)
    ids = torch.stack(rev[::-1], dim=-1)                   # [B, K, T]
    # everything from the first eos on is eos
    hit = torch.cumsum((ids == eos).to(torch.int32), dim=-1)
    ids = torch.where(hit > 0, eos, ids)
    scores = cum
    if lp > 0:
        scores = scores / torch.pow(flens.to(torch.float32) + 1e-6, lp)
    return {"Ids": ids, "Scores": scores, "Lens": flens}


@register_op("beam_search_decode")
def _beam_search_decode(ctx, ins, attrs):
    """beam_search_decode_op compat: ``beam_search`` already backtraces,
    so this passes (Ids, Scores) through."""
    return {"SentenceIds": ins["Ids"][0], "SentenceScores": ins["Scores"][0]}


@register_op("recurrent")
def _recurrent_alias(ctx, ins, attrs):
    """RecurrentOp name-compat alias of the ``rnn`` lowering."""
    return get_op_impl("rnn")(ctx, ins, attrs)
