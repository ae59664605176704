"""Beam search and the decode cache's attention (counterpart of
``beam_search``, ``beam_search_decode``, the ``recurrent`` alias and
``attention_with_cache`` in ``paddle_tpu/ops/generation_ops.py:15-209``;
see ``layers/generation.py`` for the layers that build the ops).

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

``attention_with_cache`` is plain torch, as its counterpart is plain JAX
(no Pallas kernel): a per-row append into fixed-shape cache slabs and a
causal attention over them in fp32.  Every output row depends only on
its own row of the inputs: the decode pool (``serving/decode.py``) relies
on that to admit and evict slots without moving a surviving sequence's
bits.  TF32 must stay off on a card (torch's default for matmuls), or
fp32 stops matching the reference.
"""
from __future__ import annotations

import math

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


@register_op("attention_with_cache")
def _attention_with_cache(ctx, ins, attrs):
    """Causal attention over fixed-shape KV-cache slabs.

    Q, K, V [B, Tq, D] are this dispatch's projections; CacheK/CacheV
    [B, Tmax, D] the persistable slabs, wired back to the same var names
    by ``CacheKOut``/``CacheVOut``; Len [B] int32 the tokens cached before
    this dispatch (the write offset and the causal base: query i sees
    keys j <= Len + i); WriteMask [B] float32, rows > 0 commit their K/V
    writes.  Scores and softmax run in fp32; Out takes Q's dtype."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    cache_k, cache_v = ins["CacheK"][0], ins["CacheV"][0]
    ln = ins["Len"][0].to(torch.int64)
    commit = (ins["WriteMask"][0] > 0)[:, None, None]
    B, Tq = q.shape[0], q.shape[1]
    Tmax = cache_k.shape[1]
    scale = float(attrs.get("scale", 0.0)) or 1.0 / math.sqrt(q.shape[-1])
    dev = q.device
    # each row's append at its own offset, the start clamped as
    # dynamic_update_slice clamps it: a masked write from a dead slot at
    # Len == Tmax stays in bounds
    pos = ln.clamp(0, Tmax - Tq)[:, None] \
        + torch.arange(Tq, device=dev)[None, :]

    def write(cache, new):
        idx = pos[:, :, None].expand(B, Tq, cache.shape[2])
        return torch.where(commit, cache.scatter(1, idx, new.to(cache.dtype)),
                           cache)

    ck, cv = write(cache_k, k), write(cache_v, v)
    scores = torch.matmul(q.to(torch.float32),
                          ck.to(torch.float32).transpose(1, 2)) * scale
    jpos = torch.arange(Tmax, device=dev)[None, None, :]
    ipos = torch.arange(Tq, device=dev)[None, :, None]
    visible = jpos <= ln[:, None, None] + ipos
    probs = torch.softmax(torch.where(visible, scores, NEG_INF), dim=-1)
    out = torch.matmul(probs, cv.to(torch.float32)).to(q.dtype)
    return {"Out": out, "CacheKOut": ck, "CacheVOut": cv}


# ---------------------------------------------------------------------------
# Sharding propagation (analysis.shard_prop): beam search is decode-time
# data-dependent machinery — registering the explicit noop states that its
# outputs are treated replicated (beams are small; sharding them is
# never the plan), rather than leaving a PT042 blind spot.
# attention_with_cache: the decode slot pool is a single-host serving
# construct — its batch axis is the slot axis and the cache slabs are
# session state, neither of which is ever mesh-sharded.  Replicated
# outputs, stated explicitly.  ``recurrent`` binds its outputs from its
# sub-block: no rule of either kind (SHAPE_INFER_ALLOWLIST; a blind spot).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import first  # noqa: E402
from ..analysis.shard_prop import shard_noop  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)

register_shard_fn("beam_search", "beam_search_decode",
                  "attention_with_cache")(shard_noop())


@register_shape_fn("attention_with_cache")
def _attention_with_cache_shape(op, ins, attrs):
    # Out mirrors Q; the cache outputs mirror their state slabs (the
    # optimizer-op ParamOut <- Param convention for in-place threading)
    return {"Out": first(ins, "Q"),
            "CacheKOut": first(ins, "CacheK"),
            "CacheVOut": first(ins, "CacheV")}
