"""Sequence ops over the padded+lengths form (counterpart of
``paddle_tpu/ops/sequence_ops.py``: every op it registers, with its
helpers ``_mask``, ``_in_lens``, ``_seq_lens_or_full``,
``_masked_reverse`` and ``_ACT``).

A sequence var is a padded dense tensor [B, T, ...] with a ``name@LEN``
companion of B integer lengths (``ExecContext.get_len``), and a nested
one [B, S, T, ...] adds ``name@LEN2`` [B, S]; every op masks by length.
Where the JAX package scans a recurrence with ``lax.scan``, the port
runs a Python loop over T under autograd.  Gate layouts: LSTM
[i | f | c | o] (input, forget, candidate, output), GRU [u | r | c]
(update, reset, candidate).  The JAX package has no Pallas kernel
here: each op is plain torch on the tensor's device, and its shapes are
the JAX lowering's static ones, which a CUDA graph holds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op, register_tunable
from .generation_ops import top_k as _tie_exact_top_k
from .tensor_ops import _constant

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


def _seq_lens_or_full(ctx, x, slot="X", idx=0):
    """The lengths of input ``slot``[``idx``], or every row at the full
    T = x.shape[1]."""
    lens = _in_lens(ctx, slot, idx)
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
# The lod family: masked gathers and scatters over the padded layout
# (sequence_ops.py:128-440, 563-618 in the JAX package)
# ---------------------------------------------------------------------------
def _bshape(B, T, ndim):
    """(B, T, 1, ...) for a [B, T] mask against a rank-``ndim`` value."""
    return (B, T) + (1,) * (ndim - 2)


@register_op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over time of X [B, T] (or [B, T, 1]), masked to each
    sequence's length; Out carries X's lengths.  The masked positions
    are filled with the dtype's lowest finite value, so a row of length
    0 is zeros in every dtype (the JAX package's -3.4e38 fill rounds to
    -inf in bf16, where that row is NaN: ROADMAP Queue C)."""
    x = ins["X"][0]
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x.squeeze(-1) if squeeze else x
    lens = _seq_lens_or_full(ctx, v)
    m = _mask(lens, v.shape[1], torch.bool)
    out = torch.softmax(torch.where(m, v, torch.finfo(v.dtype).min), dim=1)
    out = out * m.to(out.dtype)
    ctx.set_len(ctx.op.outputs["Out"][0], lens)
    return {"Out": out[..., None] if squeeze else out}


@register_op("sequence_expand", "sequence_expand_as")
def _sequence_expand(ctx, ins, attrs):
    """A rank-2 X [B, D] broadcast along Y's time [B, T, D]; an X of Y's
    rank passes through (the JAX package's reading, ROADMAP Queue C);
    either way masked by Y's lengths, which Out carries."""
    x, y = ins["X"][0], ins["Y"][0]
    lens = _seq_lens_or_full(ctx, y, slot="Y")
    T = y.shape[1]
    out = x if x.dim() == y.dim() else \
        x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    out = out * _mask(lens, T, out.dtype).reshape(
        _bshape(out.shape[0], T, out.dim()))
    ctx.set_len(ctx.op.outputs["Out"][0], lens)
    return {"Out": out}


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    """Each row's sequences joined along time, then padded to the sum of
    the inputs' T: out[b] = x0[b, :l0] ++ x1[b, :l1] ++ ... (one gather
    from the stacked, padded inputs); Out's lengths are the sums."""
    xs = ins["X"]
    B = xs[0].shape[0]
    lens = [_seq_lens_or_full(ctx, x, "X", i) for i, x in enumerate(xs)]
    total = sum(lens)
    T_out = sum(x.shape[1] for x in xs)
    tpos = torch.arange(T_out, device=xs[0].device)[None, :]
    src = torch.zeros((B, T_out), dtype=torch.int64, device=xs[0].device)
    off = tpos.expand(B, T_out)
    start = torch.zeros_like(lens[0])
    for k in range(len(xs)):
        sel = tpos >= start[:, None]
        src = torch.where(sel, k, src)
        off = torch.where(sel, tpos - start[:, None], off)
        start = start + lens[k]
    nd = xs[0].dim()
    padded = torch.stack([F.pad(x, (0, 0) * (nd - 2)
                                + (0, T_out - x.shape[1])) for x in xs])
    rows = torch.arange(B, device=xs[0].device)[:, None]
    out = padded[src, rows, torch.clamp(off, 0, T_out - 1)]
    out = out * _mask(total, T_out, out.dtype).reshape(
        _bshape(B, T_out, out.dim()))
    ctx.set_len(ctx.op.outputs["Out"][0], total)
    return {"Out": out}


@register_op("sequence_context")
def _sequence_context(ctx, ins, attrs):
    """v1 ContextProjection without its matmul: X [B, T, D] to
    [B, T, contextLength * D], the steps from ``contextStart`` on side
    by side.  A position before the sequence reads PadW's row
    begin_pad + src and one past its end row begin_pad + (src - len)
    (PadW [begin_pad + end_pad, D], trainable), or zeros without PadW."""
    x = ins["X"][0]
    pad_w = ins["PadW"][0] if ins.get("PadW") else None
    lens = _seq_lens_or_full(ctx, x)
    ctx_len = attrs.get("contextLength", 3)
    start = attrs.get("contextStart", -(ctx_len // 2))
    begin_pad = max(0, -start)
    T = x.shape[1]
    m = _mask(lens, T, x.dtype)[..., None]
    xm = x * m
    t = torch.arange(T, device=x.device)
    ln = lens.to(torch.int64)[:, None]
    cols = []
    for j in range(ctx_len):
        src = t + (start + j)
        base = xm.index_select(1, torch.clamp(src, 0, T - 1))
        under = (src < 0)[None, :, None]
        over = (src[None, :] >= ln)[..., None]
        if pad_w is None:
            col = torch.where(under | over, 0.0, base).to(x.dtype)
        else:
            last = pad_w.shape[0] - 1
            u_rows = pad_w[torch.clamp(begin_pad + src, 0, last)][None]
            o_rows = pad_w[torch.clamp(begin_pad + (src[None, :] - ln), 0,
                                       last)]
            col = torch.where(under, u_rows.to(x.dtype), base)
            col = torch.where(over, o_rows.to(x.dtype), col)
        cols.append(col)
    out = torch.cat(cols, dim=-1) * m
    ctx.set_len(ctx.op.outputs["Out"][0], lens)
    return {"Out": out}


@register_op("sub_nested_seq")
def _sub_nested_seq(ctx, ins, attrs):
    """Subsequences of a nested X [B, S, T, ...] picked by Selection
    [B, K] (SubNestedSequenceLayer): an index below 0 (kmax_seq_score's
    pad) or at S or above gives zeros and no length, so Out's lengths
    count the valid picks and its ``@LEN2`` holds theirs."""
    x = ins["X"][0]
    sel = ins["Selection"][0].to(torch.int64)
    if sel.dim() == 1:
        sel = sel[:, None]
    S = x.shape[1]
    valid = (sel >= 0) & (sel < S)
    safe = torch.clamp(sel, 0, S - 1)
    tail = (1,) * (x.dim() - 2)
    out = torch.gather(x, 1, safe.reshape(tuple(safe.shape) + tail).expand(
        tuple(safe.shape) + tuple(x.shape[2:])))
    out = out * valid.reshape(tuple(valid.shape) + tail).to(x.dtype)
    name = ctx.op.outputs["Out"][0]
    lens2 = ctx.get_len2(ctx.op.inputs["X"][0])
    if lens2 is not None:
        ctx.set_len2(name, torch.gather(lens2, 1, safe)
                     * valid.to(lens2.dtype))
    ctx.set_len(name, valid.sum(dim=1).to(torch.int32))
    return {"Out": out}


@register_op("conv2d_dynamic_filter")
def _conv2d_dynamic_filter(ctx, ins, attrs):
    """v1 conv_operator: a convolution whose Filter is another layer's
    output.  One filter set a sample (Filter [B, O*I*kh*kw]) is one
    grouped convolution with the batch folded into the channels
    (groups = B); a single set is a plain convolution."""
    x = ins["Input"][0]
    w = ins["Filter"][0].to(x.dtype)
    O, I, kh, kw = attrs["filter_shape"]
    stride = tuple(attrs.get("strides", [1, 1]))
    pad = tuple(attrs.get("paddings", [0, 0]))
    B = x.shape[0]
    if w.dim() == 2 and w.shape[0] == B and w.numel() == B * O * I * kh * kw:
        out = F.conv2d(x.reshape((1, B * x.shape[1]) + tuple(x.shape[2:])),
                       w.reshape(B * O, I, kh, kw), stride=stride,
                       padding=pad, groups=B)
        return {"Output": out.reshape((B, O) + tuple(out.shape[2:]))}
    return {"Output": F.conv2d(x, w.reshape(O, I, kh, kw), stride=stride,
                               padding=pad)}


@register_op("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """Each row's steps [Offset, Offset + Length) moved to the front, the
    rest zero; Out's lengths are Length."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1).to(torch.int64)
    length = ins["Length"][0].reshape(-1).to(torch.int32)
    B, T = x.shape[0], x.shape[1]
    tpos = torch.arange(T, device=x.device)[None, :]
    idx = torch.clamp(offset[:, None] + tpos, 0, T - 1)
    out = torch.gather(x, 1, idx.reshape(_bshape(B, T, x.dim())).expand(
        x.shape))
    out = out * _mask(length, T, x.dtype).reshape(_bshape(B, T, x.dim()))
    ctx.set_len(ctx.op.outputs["Out"][0], length)
    return {"Out": out}


@register_op("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    """Each row's valid steps in reverse order, the padding in place; the
    output (slot Y, or Out) carries X's lengths."""
    x = ins["X"][0]
    lens = _seq_lens_or_full(ctx, x)
    slot = "Y" if "Y" in ctx.op.outputs else "Out"
    ctx.set_len(ctx.op.outputs[slot][0], lens)
    return {slot: _masked_reverse(x, lens)}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    """X [B, T, D] to [B, T * D / new_dim, new_dim]; the lengths become
    (len * D) // new_dim (the JAX package's scaling, ROADMAP Queue C)."""
    x = ins["X"][0]
    new_dim = attrs["new_dim"]
    B, T, D = x.shape
    if (T * D) % new_dim:
        raise ValueError(f"sequence_reshape: T*D={T * D} not divisible by "
                         f"new_dim {new_dim}")
    lens = _seq_lens_or_full(ctx, x)
    ctx.set_len(ctx.op.outputs["Out"][0], (lens * D) // new_dim)
    return {"Out": x.reshape(B, T * D // new_dim, new_dim)}


@register_op("sequence_pad")
def _sequence_pad(ctx, ins, attrs):
    """The padded form already is the padded sequence: Out is X, Length
    its lengths."""
    x = ins["X"][0]
    return {"Out": x, "Length": _seq_lens_or_full(ctx, x)}


@register_op("sequence_unpad")
def _sequence_unpad(ctx, ins, attrs):
    """Out is X with the lengths of ``Length`` (or X's own)."""
    x = ins["X"][0]
    lens = ins["Length"][0] if ins.get("Length") else \
        _seq_lens_or_full(ctx, x)
    ctx.set_len(ctx.op.outputs["Out"][0], lens.reshape(-1))
    return {"Out": x}


@register_op("lod_reset")
def _lod_reset(ctx, ins, attrs):
    """Out is X with new lengths: Y's values, or the differences of the
    ``target_lod`` offsets (a host constant, copied to the card on a
    step that is not captured, ``tensor_ops._constant``)."""
    x = ins["X"][0]
    if ins.get("Y"):
        lens = ins["Y"][0].reshape(-1).to(torch.int32)
    else:
        offs = list(attrs.get("target_lod", []))
        lens = _constant(ctx, [b - a for a, b in zip(offs, offs[1:])],
                         torch.int32, x.device)
    ctx.set_len(ctx.op.outputs["Out"][0], lens)
    return {"Out": x}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead convolution (DeepSpeech2): out[b, t] = the sum over j of
    x[b, t + j] * Filter[j], Filter [future_context + 1, D], within the
    sequence; Out carries X's lengths."""
    x, w = ins["X"][0], ins["Filter"][0]
    lens = _seq_lens_or_full(ctx, x)
    T = x.shape[1]
    m = _mask(lens, T, x.dtype)[..., None]
    xm = x * m
    t = torch.arange(T, device=x.device)
    out = torch.zeros_like(x)
    for j in range(w.shape[0]):
        valid = (t + j < T)[None, :, None].to(x.dtype)
        out = out + torch.roll(xm, -j, dims=1) * valid * w[j][None, None, :]
    ctx.set_len(ctx.op.outputs["Out"][0], lens)
    return {"Out": out * m}


@register_op("max_sequence_len")
def _max_sequence_len(ctx, ins, attrs):
    """The largest length of RankTable's (or X's) ``@LEN``, or X's T
    without one, as an int64 scalar (int32 in the JAX package without
    x64, ROADMAP Queue C), made on the device with no host copy."""
    slot = "RankTable" if "RankTable" in ctx.op.inputs else "X"
    lens = _in_lens(ctx, slot)
    if lens is None:
        x = next(iter(ins.values()))[0]
        return {"Out": torch.full((), x.shape[1], dtype=torch.int64,
                                  device=x.device)}
    return {"Out": lens.max().to(torch.int64)}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One LSTM step from gates X [B, 4H] ([i | f | c | o]) and C_prev
    [B, H]: C and H; ``forget_bias`` is added to f before its
    sigmoid.  A bf16 step computes in fp32 and rounds C and H once, as
    XLA's fused step does."""
    gates, c_prev = ins["X"][0], ins["C_prev"][0]
    dtype = torch.promote_types(gates.dtype, c_prev.dtype)
    gi, gf, gc, go = torch.chunk(gates.float() if dtype == torch.bfloat16
                                 else gates, 4, dim=-1)
    c = torch.sigmoid(gf + attrs.get("forget_bias", 0.0)) * c_prev \
        + torch.sigmoid(gi) * torch.tanh(gc)
    h = torch.sigmoid(go) * torch.tanh(c)
    return {"C": c.to(dtype), "H": h.to(dtype)}


@register_op("kmax_seq_score")
def _kmax_seq_score(ctx, ins, attrs):
    """The positions of each sequence's ``beam_size`` largest scores in
    X [B, T] (or [B, T, 1]), padding excluded, ranked as ``lax.top_k``
    ranks (a tie to the lower position, ``generation_ops.top_k``), -1
    where a sequence is shorter than k; int64 [B, k] (int32 in the JAX
    package without x64)."""
    x = ins["X"][0]
    if x.dim() == 3:
        x = x[..., 0]
    k = int(attrs.get("beam_size", attrs.get("k", 1)))
    lens = _seq_lens_or_full(ctx, x).to(torch.int64)
    T = x.shape[1]
    # fp32 holds every bf16 value exactly, so the order is the input's
    masked = torch.where(torch.arange(T, device=x.device)[None, :]
                         < lens[:, None], x.float(), -3.4e38)
    k_eff = min(k, T)
    _, idx = _tie_exact_top_k(masked, k_eff)
    valid = torch.arange(k_eff, device=x.device)[None, :] < \
        torch.clamp_max(lens, k_eff)[:, None]
    out = torch.where(valid, idx, -1)
    if k_eff < k:
        out = F.pad(out, (0, k - k_eff), value=-1)
    return {"Out": out}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer) over the padded+lengths
# representation — the InferShape analogs of sequence_*_op.cc and
# lstm_op.cc/gru_op.cc.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo,  # noqa: E402
                                    conv_out_dim, dim_ok, first, same_as)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn("sequence_softmax", "sequence_slice", "sequence_unpad",
                  "lod_reset", "row_conv")(same_as("X"))


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


@register_shape_fn("sequence_expand", "sequence_expand_as")
def _sequence_expand_shape(op, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if x.shape is None:
        return {"Out": x}
    if y.shape is not None and len(y.shape) >= 2 and \
            len(x.shape) < len(y.shape):
        return {"Out": x.with_shape(x.shape[:1] + (y.shape[1],)
                                    + x.shape[1:])}
    return {"Out": x}


@register_shape_fn("sequence_concat")
def _sequence_concat_shape(op, ins, attrs):
    xs = [v for v in ins.get("X", []) if v is not None]
    known = [v for v in xs if v.shape is not None]
    if not known or len(known) != len(xs):
        return {"Out": VarInfo(None, xs[0].dtype if xs else None)}
    base = known[0]
    t = 0
    for v in known:
        if len(v.shape) != len(base.shape) or \
                not all(dim_ok(a, b) for a, b in
                        zip(v.shape[2:], base.shape[2:])):
            raise ShapeError(
                f"sequence_concat: feature dims differ: "
                f"{list(base.shape)} vs {list(v.shape)}")
        t = -1 if t < 0 or v.shape[1] < 0 else t + v.shape[1]
    return {"Out": base.with_shape(base.shape[:1] + (t,) + base.shape[2:])}


@register_shape_fn("sequence_context")
def _sequence_context_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    if len(x.shape) != 3:
        raise ShapeError(
            f"sequence_context: X must be [B, T, D], got {list(x.shape)}")
    b, t, d = x.shape
    ctx_len = attrs.get("contextLength", 3)
    return {"Out": x.with_shape((b, t, -1 if d < 0 else ctx_len * d))}


@register_shape_fn("sub_nested_seq")
def _sub_nested_seq_shape(op, ins, attrs):
    x, sel = first(ins, "X"), first(ins, "Selection")
    if x.shape is None or sel.shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    k = sel.shape[1] if len(sel.shape) >= 2 else 1
    return {"Out": x.with_shape(x.shape[:1] + (k,) + x.shape[2:])}


@register_shape_fn("conv2d_dynamic_filter")
def _conv2d_dynamic_filter_shape(op, ins, attrs):
    x = first(ins, "Input")
    if x.shape is None:
        return {"Output": x}
    o, i, kh, kw = attrs["filter_shape"]
    strides = tuple(attrs.get("strides", [1, 1]))
    pads = tuple(attrs.get("paddings", [0, 0]))
    return {"Output": VarInfo(
        (x.shape[0], o, conv_out_dim(x.shape[2], kh, pads[0], strides[0]),
         conv_out_dim(x.shape[3], kw, pads[1], strides[1])), x.dtype)}


@register_shape_fn("sequence_reverse")
def _sequence_reverse_shape(op, ins, attrs):
    x = first(ins, "X")
    out_slot = "Y" if op.outputs.get("Y") else "Out"
    return {out_slot: x}


@register_shape_fn("sequence_reshape")
def _sequence_reshape_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    new_dim = attrs["new_dim"]
    b, t, d = x.shape
    if t >= 0 and d >= 0:
        if (t * d) % new_dim:
            raise ShapeError(
                f"sequence_reshape: T*D={t * d} not divisible by new_dim "
                f"{new_dim}")
        return {"Out": x.with_shape((b, t * d // new_dim, new_dim))}
    return {"Out": x.with_shape((b, -1, new_dim))}


@register_shape_fn("sequence_pad")
def _sequence_pad_shape(op, ins, attrs):
    x = first(ins, "X")
    b = x.shape[0] if x.shape is not None else -1
    return {"Out": x, "Length": VarInfo((b,), "int32")}


@register_shape_fn("max_sequence_len")
def _max_sequence_len_shape(op, ins, attrs):
    return {"Out": VarInfo((), "int64")}


@register_shape_fn("lstm_unit")
def _lstm_unit_shape(op, ins, attrs):
    gates, c_prev = first(ins, "X"), first(ins, "C_prev")
    if gates.shape is not None and c_prev.shape is not None and \
            gates.shape[-1] >= 0 and c_prev.shape[-1] >= 0 and \
            gates.shape[-1] != 4 * c_prev.shape[-1]:
        raise ShapeError(
            f"lstm_unit: gates width {gates.shape[-1]} != 4 * H "
            f"{c_prev.shape[-1]}")
    return {"C": c_prev, "H": c_prev}


@register_shape_fn("kmax_seq_score")
def _kmax_seq_score_shape(op, ins, attrs):
    x = first(ins, "X")
    b = x.shape[0] if x.shape is not None else -1
    k = int(attrs.get("beam_size", attrs.get("k", 1)))
    return {"Out": VarInfo((b, k), "int64")}


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
# the recurrent weight shard the same axis).  The ops without a rule here
# have none in the JAX package either (blind spots).
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (first_in, merge_entry,  # noqa: E402
                                   shard_noop, shard_same_as)
from ..core.registry import register_shard_fn  # noqa: E402

# lod_reset's rule sits in the JAX package's tensor_ops.py (:732-734)
register_shard_fn("sequence_softmax", "lod_reset")(shard_same_as("X"))
register_shard_fn("sequence_reverse")(shard_same_as("X", out="Y"))
register_shard_fn("sequence_unpad", "sequence_pad")(shard_noop())


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
