"""Sequence ops over the padded+lengths form (counterpart of
``sequence_pool``, ``sequence_conv``, ``lstm``, ``gru`` and ``gru_unit``
in ``paddle_tpu/ops/sequence_ops.py``, with its helpers ``_mask``,
``_in_lens``, ``_seq_lens_or_full``, ``_masked_reverse`` and ``_ACT``).

A sequence var is a padded dense tensor [B, T, ...] with a ``name@LEN``
companion of B integer lengths (``ExecContext.get_len``); every op masks
by length.  Where the JAX package scans a recurrence with ``lax.scan``,
the port runs a Python loop over T under autograd.  Gate layouts: LSTM
[i | f | c | o] (input, forget, candidate, output), GRU [u | r | c]
(update, reset, candidate).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op, register_tunable

# A pending kernel candidate (the JAX package's sequence_ops.py:37), with a
# rule of its own for the card: the lod sequence family (sequence_expand/
# pool/concat/slice/pad/unpad, ...) is gather/scatter over padded
# [B, T, ...] layouts, which the plain torch ops do as masked selects
# and reductions that re-read the padded tensor an op.  The candidate is
# hand-written CUDA gather/scatter kernels indexed by the @LEN
# companions.  No kernel exists in either package; opprof's report names
# this rule where lod sequence op classes dominate a measured profile.
register_tunable(
    "cuda/lod_gather_scatter", side="device",
    space={"kernel": ("torch", "cuda"), "block_rows": (128, 256, 512)},
    default={"kernel": "torch", "block_rows": 256},
    description="route the lod gather/scatter sequence ops (sequence_"
                "expand/pool/concat/slice/pad/unpad families) through "
                "hand-written CUDA kernels indexed by @LEN instead of the "
                "plain torch masked forms",
    pending_hardware=True,
    decision_rule="flip kernel=cuda only when an on-card paired A/B over "
                  "a sequence-heavy captured step (benchmark.opprof's "
                  "lstm workload, H100) shows >= 1.15x median step time "
                  "with >= 75% of pairs favoring, AND the opprof per-op "
                  "table attributes >= 10% of the step's measured device "
                  "time to lod sequence op classes")


def _mask(lens, T, dtype=torch.float32):
    """[B, T] validity mask from lengths [B]."""
    return (torch.arange(T, device=lens.device)[None, :]
            < lens[:, None]).to(dtype)


def _in_lens(ctx, slot="X", idx=0):
    return ctx.get_len(ctx.op.inputs[slot][idx])


def _seq_lens_or_full(ctx, x, slot="X"):
    """The input's lengths, or every row at the full T = x.shape[1]."""
    lens = _in_lens(ctx, slot)
    if lens is None:
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    return lens


def _masked_reverse(x, lens):
    """Reverse the first ``lens[b]`` steps of each row; padding stays
    put (sequence_reverse semantics)."""
    B, T = x.shape[0], x.shape[1]
    tpos = torch.arange(T, device=x.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    idx = torch.where(tpos < lens, lens - 1 - tpos, tpos)
    idx = idx.reshape((B, T) + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


_ACT = {
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
    "identity": lambda x: x,
}


@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    """AVERAGE/SUM/SQRT/MAX/LAST/FIRST over time.

    A nested input ([B, S, T, ...] with an ``@LEN2`` companion [B, S]):
    LAST is the last valid token of the last valid subsequence, FIRST
    the first token of the first."""
    x = ins["X"][0]
    lens = _seq_lens_or_full(ctx, x).to(torch.int64)
    ptype = attrs.get("pooltype", attrs.get("pool_type", "AVERAGE")).upper()
    lens2 = ctx.get_len2(ctx.op.inputs["X"][0])
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    if lens2 is not None:
        if ptype == "LAST":
            last_s = torch.clamp_min(lens - 1, 0)
            inner = lens2.to(torch.int64).gather(1, last_s[:, None])[:, 0]
            return {"Out": x[rows, last_s, torch.clamp_min(inner - 1, 0)]}
        if ptype == "FIRST":
            return {"Out": x[:, 0, 0]}
        raise NotImplementedError(
            f"sequence_pool {ptype} over nested sequences: only LAST/FIRST "
            f"are defined (matching last_seq/first_seq use)")
    if ptype == "AVG":                 # v1 AvgPooling spelling
        ptype = "AVERAGE"
    T = x.shape[1]
    m = _mask(lens, T, x.dtype).reshape((B, T) + (1,) * (x.dim() - 2))
    if ptype in ("SUM", "AVERAGE", "SQRT"):
        out = torch.sum(x * m, dim=1)
        if ptype != "SUM":
            n = torch.clamp_min(lens.to(x.dtype), 1)
            if ptype == "SQRT":
                n = torch.sqrt(n)
            out = out / n.reshape((-1,) + (1,) * (out.dim() - 1))
    elif ptype == "MAX":
        # a Python scalar: no host-to-device copy (capturable)
        out = torch.amax(torch.where(m > 0, x, -3.4e38), dim=1)
    elif ptype == "LAST":
        out = x[rows, torch.clamp_min(lens - 1, 0)]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": out}


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window projection along time (``sequence_ops.py:300-327``):
    each step's ``contextLength`` neighbours from ``contextStart`` on,
    zero outside the sequence, concatenated [B, T, L * D] and multiplied
    by Filter [L * D, M]; Out carries X's lengths."""
    x, w = ins["X"][0], ins["Filter"][0]
    lens = _seq_lens_or_full(ctx, x)
    if attrs.get("contextStride", 1) != 1:
        raise ValueError("sequence_conv supports contextStride 1 (as the "
                         "reference)")
    ctx_len = attrs.get("contextLength", 3)
    start = attrs.get("contextStart", -(ctx_len // 2))
    T = x.shape[1]
    m = _mask(lens, T, x.dtype)[..., None]
    xm = x * m
    t = torch.arange(T, device=x.device)
    cols = []
    for j in range(ctx_len):
        shift = start + j
        valid = ((t + shift >= 0) & (t + shift < T)).to(x.dtype)
        cols.append(torch.roll(xm, -shift, dims=1) * valid[None, :, None])
    out = (torch.cat(cols, dim=-1) @ w) * m
    ctx.set_len(ctx.op.outputs["Out"][0], lens)
    return {"Out": out}


@register_op("lstm")
def _lstm(ctx, ins, attrs):
    """Dynamic LSTM over a pre-projected Input [B, T, 4H]
    (``sequence_ops.py:453-514``): recurrent Weight [H, 4H], Bias [1, 4H]
    with the peephole weights (i, f, o) as a [1, 3H] tail when
    ``use_peepholes``; optional H0, C0 [B, H].  Finished rows keep their
    state and output zeros; ``is_reverse`` runs each row's valid steps
    back to front.  Hidden and Cell [B, T, H] carry the input's
    lengths."""
    x, w = ins["Input"][0], ins["Weight"][0]
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    lens = _seq_lens_or_full(ctx, x, slot="Input")
    B, T, H4 = x.shape
    H = H4 // 4
    use_peep = attrs.get("use_peepholes", False) and bias is not None
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    b_gate = bias[:4 * H] if bias is not None else None
    if use_peep:
        wi, wf, wo = bias[4 * H:5 * H], bias[5 * H:6 * H], bias[6 * H:7 * H]
    h = ins["H0"][0] if ins.get("H0") else \
        torch.zeros((B, H), dtype=x.dtype, device=x.device)
    c = ins["C0"][0] if ins.get("C0") else \
        torch.zeros((B, H), dtype=x.dtype, device=x.device)
    is_reverse = attrs.get("is_reverse", False)
    if is_reverse:
        x = _masked_reverse(x, lens)
    mask = _mask(lens, T, x.dtype)
    hs, cs = [], []
    for t in range(T):
        mt = mask[:, t, None]
        gates = x[:, t] + h @ w
        if b_gate is not None:
            gates = gates + b_gate
        gi, gf, gc, go = torch.split(gates, H, dim=-1)
        if use_peep:
            gi = gi + c * wi
            gf = gf + c * wf
        c_new = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        if use_peep:
            go = go + c_new * wo
        h_new = gate_act(go) * cell_act(c_new)
        h = mt * h_new + (1 - mt) * h
        c = mt * c_new + (1 - mt) * c
        hs.append(h * mt)
        cs.append(c * mt)
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    if is_reverse:
        hidden = _masked_reverse(hidden, lens)
        cell = _masked_reverse(cell, lens)
    for slot in ("Hidden", "Cell"):
        if ctx.op.outputs.get(slot):
            ctx.set_len(ctx.op.outputs[slot][0], lens)
    return {"Hidden": hidden, "Cell": cell}


@register_op("gru")
def _gru(ctx, ins, attrs):
    """Dynamic GRU over a pre-projected Input [B, T, 3H]; Weight [H, 3H]
    laid out [u | r | c]; Bias [1, 3H].  Finished rows keep their state
    and output zeros; ``is_reverse`` runs each row's valid steps back to
    front.  Hidden [B, T, H] carries the input's lengths."""
    x, w = ins["Input"][0], ins["Weight"][0]
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    lens = _seq_lens_or_full(ctx, x, slot="Input")
    B, T, H3 = x.shape
    H = H3 // 3
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    w_ur, w_c = w[:, :2 * H], w[:, 2 * H:]
    h = ins["H0"][0] if ins.get("H0") else \
        torch.zeros((B, H), dtype=x.dtype, device=x.device)
    is_reverse = attrs.get("is_reverse", False)
    if is_reverse:
        x = _masked_reverse(x, lens)
    mask = _mask(lens, T, x.dtype)
    hs = []
    for t in range(T):
        xt, mt = x[:, t], mask[:, t, None]
        ur = xt[:, :2 * H] + h @ w_ur
        if bias is not None:
            ur = ur + bias[:2 * H]
        u, r = torch.split(gate_act(ur), H, dim=-1)
        c = xt[:, 2 * H:] + (r * h) @ w_c
        if bias is not None:
            c = c + bias[2 * H:]
        c = cand_act(c)
        h_new = u * h + (1.0 - u) * c
        h = mt * h_new + (1 - mt) * h
        hs.append(h * mt)
    hidden = torch.stack(hs, dim=1)
    if is_reverse:
        hidden = _masked_reverse(hidden, lens)
    if ctx.op.outputs.get("Hidden"):
        ctx.set_len(ctx.op.outputs["Hidden"][0], lens)
    return {"Hidden": hidden}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step: Input [B, 3H], HiddenPrev [B, H], Weight [H, 3H];
    Hidden, the gates Gate = [u | r] and ResetHiddenPrev = r * h."""
    x, h, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    H = h.shape[-1]
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    ur = x[:, :2 * H] + h @ w[:, :2 * H]
    if bias is not None:
        ur = ur + bias[:2 * H]
    g = gate_act(ur)
    u, r = g[:, :H], g[:, H:]
    c = x[:, 2 * H:] + (r * h) @ w[:, 2 * H:]
    if bias is not None:
        c = c + bias[2 * H:]
    c = cand_act(c)
    h_new = u * h + (1.0 - u) * c
    return {"Hidden": h_new, "Gate": g, "ResetHiddenPrev": r * h}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer) over the padded+lengths
# representation — the InferShape analogs of sequence_*_op.cc and
# lstm_op.cc/gru_op.cc.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo,  # noqa: E402
                                    dim_ok, first)
from ..core.registry import register_shape_fn  # noqa: E402


@register_shape_fn("sequence_pool")
def _sequence_pool_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None or len(x.shape) < 2:
        return {"Out": VarInfo(None, x.dtype)}
    # [B, T, ...] -> [B, ...]; the nested (lod-2) LAST/FIRST form drops two
    # dims, but lod levels are runtime metadata — stay at the common case
    # and let the declaration fill the gap when it disagrees in rank only.
    return {"Out": x.with_shape(x.shape[:1] + x.shape[2:])}


@register_shape_fn("sequence_conv")
def _sequence_conv_shape(op, ins, attrs):
    x, w = first(ins, "X"), first(ins, "Filter")
    if x.shape is None:
        return {"Out": x}
    if w.shape is not None and x.shape[-1] >= 0 and w.shape[0] >= 0:
        ctx_len = attrs.get("contextLength", 3)
        if w.shape[0] != ctx_len * x.shape[-1]:
            raise ShapeError(
                f"sequence_conv: Filter rows {w.shape[0]} != "
                f"contextLength {ctx_len} * D {x.shape[-1]}")
    m = w.shape[-1] if w.shape is not None else -1
    return {"Out": x.with_shape(x.shape[:-1] + (m,))}


@register_shape_fn("lstm")
def _lstm_shape(op, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Weight")
    if x.shape is None:
        return {"Hidden": x, "Cell": x}
    b, t, h4 = x.shape
    if h4 >= 0 and h4 % 4:
        raise ShapeError(f"lstm: input width {h4} is not 4*H")
    h = -1 if h4 < 0 else h4 // 4
    if w.shape is not None and h >= 0 and \
            (len(w.shape) != 2
             or not all(dim_ok(a, b)
                        for a, b in zip(w.shape, (h, h4)))):
        raise ShapeError(
            f"lstm: Weight {list(w.shape)} != [H, 4H] = [{h}, {h4}]")
    info = VarInfo((b, t, h), x.dtype)
    return {"Hidden": info, "Cell": info}


@register_shape_fn("gru")
def _gru_shape(op, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Weight")
    if x.shape is None:
        return {"Hidden": x}
    b, t, h3 = x.shape
    if h3 >= 0 and h3 % 3:
        raise ShapeError(f"gru: input width {h3} is not 3*H")
    h = -1 if h3 < 0 else h3 // 3
    if w.shape is not None and h >= 0 and \
            (len(w.shape) != 2
             or not all(dim_ok(a, b)
                        for a, b in zip(w.shape, (h, h3)))):
        raise ShapeError(
            f"gru: Weight {list(w.shape)} != [H, 3H] = [{h}, {h3}]")
    return {"Hidden": VarInfo((b, t, h), x.dtype)}


@register_shape_fn("gru_unit")
def _gru_unit_shape(op, ins, attrs):
    x, h = first(ins, "Input"), first(ins, "HiddenPrev")
    res = {"Hidden": h}
    if h.shape is not None and h.shape[-1] >= 0:
        res["Gate"] = h.with_shape(h.shape[:-1] + (2 * h.shape[-1],))
        res["ResetHiddenPrev"] = h
    return res


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  Recurrences keep the
# batch sharding; the lstm/gru gate dim follows the Weight's column split
# (the Megatron gate-parallel pattern — the col-split input projection and
# the recurrent weight shard the same axis).  sequence_conv and gru_unit
# have no rule (blind spots, as in the JAX package).
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import first_in, merge_entry  # noqa: E402
from ..core.registry import register_shard_fn  # noqa: E402


@register_shard_fn("sequence_pool")
def _sequence_pool_shard(op, ins, attrs):
    x = first_in(ins, "X")
    if x.spec is None:
        return {}
    # [B, T, D] -> [B, D]: the time dim drops
    return {"Out": (x.entry(0),) + tuple(x.spec[2:])}


@register_shard_fn("lstm")
def _lstm_shard(op, ins, attrs):
    x, w = first_in(ins, "Input"), first_in(ins, "Weight")
    if x.spec is None and w.spec is None:
        return {}
    h_entry = merge_entry(x.entry(2), w.entry(1), "lstm gate dim")
    info = ((x.entry(0), x.entry(1), h_entry))
    return {"Hidden": info, "Cell": info}


@register_shard_fn("gru")
def _gru_shard(op, ins, attrs):
    x, w = first_in(ins, "Input"), first_in(ins, "Weight")
    if x.spec is None and w.spec is None:
        return {}
    h_entry = merge_entry(x.entry(2), w.entry(1), "gru gate dim")
    return {"Hidden": (x.entry(0), x.entry(1), h_entry)}
