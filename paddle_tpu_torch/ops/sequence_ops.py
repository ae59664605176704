"""Sequence ops over the padded+lengths form (counterpart of
``sequence_pool``, ``gru`` and ``gru_unit`` in
``paddle_tpu/ops/sequence_ops.py``, with its helpers ``_mask``,
``_in_lens``, ``_seq_lens_or_full``, ``_masked_reverse`` and ``_ACT``).

A sequence var is a padded dense tensor [B, T, ...] with a ``name@LEN``
companion of B integer lengths (``ExecContext.get_len``); every op masks
by length.  Where the JAX package scans a recurrence with ``lax.scan``,
the port runs a Python loop over T under autograd.  Gate layout of the
GRU ops: [u | r | c] (update, reset, candidate).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


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
        neg = torch.tensor(-3.4e38, dtype=x.dtype, device=x.device)
        out = torch.amax(torch.where(m > 0, x, neg), dim=1)
    elif ptype == "LAST":
        out = x[rows, torch.clamp_min(lens - 1, 0)]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": out}


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
