"""Structured-prediction ops (counterpart of ``paddle_tpu/ops/crf_ops.py``):
the linear-chain CRF's negative log-likelihood, its Viterbi decoding, the
CTC loss, the edit distance, the chunk count, and ``copy_len``.

The JAX package runs each recursion as a ``lax.scan`` in log space over
the padded+lengths batch and takes its gradients from ``jax.vjp``; the
port runs the same recursions as Python loops over the static T under
autograd, on the tensor's device, so a CUDA graph holds them.  The CTC
loss is the JAX package's own recursion, not ``F.ctc_loss``: it carries
-1e30 where the library carries -inf (a label that cannot fit gives a
loss near 1e30, not inf) and is deterministic on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .sequence_ops import _mask, _seq_lens_or_full

NEG = -1e30


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) as ``jnp.logaddexp`` computes it and with its
    gradient: d/da = exp(a - out), which is 1 for two equal inputs at
    -1e30 (out rounds back to -1e30), where ``torch.logaddexp`` gives
    0.5.  A label that cannot fit keeps its CTC alphas there."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _labels(t):
    """An id tensor [B, T] (a [B, T, 1] one squeezed) as int64."""
    t = t.to(torch.int64)
    return t.squeeze(-1) if t.dim() == 3 else t


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    """Emission [B, T, D]; Transition [D + 2, D] (row 0 the start scores,
    row 1 the end scores, rows 2.. w[prev, cur]); Label [B, T] (or
    [B, T, 1]).  LogLikelihood [B, 1] is the negative log-likelihood:
    log Z by the alpha recursion in log space, a masked step carrying
    alpha on (keep * new + (1 - keep) * alpha), less the gold path's
    score; its ``@LEN`` is ones.  Alpha is the last alpha, and the
    exponentials of both inputs are the reference's extra outputs."""
    em, trans = ins["Emission"][0], ins["Transition"][0]
    label = _labels(ins["Label"][0])
    lens = _seq_lens_or_full(ctx, em, slot="Emission")
    B, T, _ = em.shape
    start, end, w = trans[0], trans[1], trans[2:]
    m = _mask(lens, T, em.dtype)
    alpha = start[None] + em[:, 0]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + w[None]
                              + em[:, t][:, None, :], dim=1)
        keep = m[:, t, None]
        alpha = keep * new + (1 - keep) * alpha
    log_z = torch.logsumexp(alpha + end[None], dim=1)
    gold = (em.gather(2, label[..., None]).squeeze(-1) * m).sum(dim=1)
    gold = gold + (w[label[:, :-1], label[:, 1:]] * m[:, 1:]).sum(dim=1)
    last = label.gather(1, torch.clamp_min(
        lens.to(torch.int64) - 1, 0)[:, None]).squeeze(1)
    gold = gold + start[label[:, 0]] + end[last]
    ctx.set_len(ctx.op.outputs["LogLikelihood"][0],
                torch.ones((B,), dtype=torch.int32, device=em.device))
    return {"LogLikelihood": (log_z - gold)[:, None], "Alpha": alpha,
            "EmissionExps": torch.exp(em), "TransitionExps": torch.exp(trans)}


@register_op("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decoding of Emission [B, T, D] under Transition: the max
    recursion with each step's first argmax as its back pointer, the
    last tag the first argmax of the final score plus the end scores,
    then the back trace from each row's last position.  ViterbiPath
    [B, T] int64 (int32 in the JAX package without x64) holds the path,
    0 past each length, with the Emission's lengths; with Label given,
    1 where the path equals the label within the length, else 0."""
    em, trans = ins["Emission"][0], ins["Transition"][0]
    in_lens = _seq_lens_or_full(ctx, em, slot="Emission")
    lens = in_lens.to(torch.int64)
    B, T, _ = em.shape
    start, end, w = trans[0], trans[1], trans[2:]
    m = _mask(lens, T, em.dtype)
    score = start[None] + em[:, 0]
    back = []
    for t in range(1, T):
        cand = score[:, :, None] + w[None]
        back.append(torch.argmax(cand, dim=1))
        keep = m[:, t, None]
        score = keep * (cand.amax(dim=1) + em[:, t]) + (1 - keep) * score
    last_tag = torch.argmax(score + end[None], dim=1)
    tag, tags = last_tag, [last_tag]
    for step in range(T - 2, -1, -1):
        prev = back[step].gather(1, tag[:, None]).squeeze(1)
        tag = torch.where(step < lens - 1, prev, tag)
        tags.append(tag)
    path = torch.stack(tags[::-1], dim=1)
    valid = m.to(torch.bool)
    path = torch.where(valid, path, 0)
    at_last = torch.arange(T, device=em.device)[None, :] == (lens - 1)[:, None]
    path = torch.where(at_last, last_tag[:, None], path)
    ctx.set_len(ctx.op.outputs["ViterbiPath"][0], in_lens)
    if ctx.op.inputs.get("Label"):
        label = _labels(ins["Label"][0])
        path = ((path == label) & valid).to(torch.int64)
    return {"ViterbiPath": path}


@register_op("warpctc")
def _warpctc(ctx, ins, attrs):
    """The CTC loss by the alpha recursion in log space (the JAX
    package's, with -1e30 for log 0).  Logits [B, T, C] before the
    softmax, with the input's lengths; Label [B, L], its lengths from
    ``Label@LEN`` or else the count of labels >= 0, a negative pad read
    as 0.  Loss [B, 1] in the logits' dtype, divided by the input
    length when ``norm_by_times``."""
    logits = ins["Logits"][0]
    label = _labels(ins["Label"][0])
    blank = attrs.get("blank", 0)
    B, T, _ = logits.shape
    L = label.shape[1]
    in_lens = _seq_lens_or_full(ctx, logits, slot="Logits")
    lab_lens = ctx.get_len(ctx.op.inputs["Label"][0])
    if lab_lens is None:
        lab_lens = (label >= 0).sum(dim=1)
    lab_lens = lab_lens.to(torch.int64)
    label = torch.clamp_min(label, 0)
    logp = torch.log_softmax(logits, dim=-1)
    dtype = logp.dtype
    dev = logits.device
    S = 2 * L + 1
    s_pos = torch.arange(S, device=dev)
    # blank l1 blank l2 ... blank
    ext = torch.where(s_pos[None, :] % 2 == 1,
                      label[:, torch.clamp_max(s_pos // 2, L - 1)], blank)
    valid_s = s_pos[None, :] < (2 * lab_lens + 1)[:, None]
    ext_m2 = F.pad(ext[:, :-2], (2, 0), value=-1)
    can_skip = (s_pos[None, :] % 2 == 1) & (ext != ext_m2)
    # every step's emission scores [B, T, S] by indexing, whose gradient
    # (an accumulating index_put_) is deterministic on the card, where a
    # gather's (scatter_add_ onto the repeated blank) is not
    rows = torch.arange(B, device=dev)[:, None, None]
    steps = torch.arange(T, device=dev)[None, :, None]
    em = logp[rows, steps, ext[:, None, :]]
    e0 = em[:, 0]
    alpha = torch.cat([e0[:, :1], torch.where(lab_lens > 0, e0[:, 1],
                                              NEG)[:, None],
                       torch.full((B, S - 2), NEG, dtype=dtype,
                                  device=dev)], dim=1)
    for t in range(1, T):
        e = em[:, t]
        a_m1 = F.pad(alpha[:, :-1], (1, 0), value=NEG)
        a_m2 = torch.where(can_skip, F.pad(alpha[:, :-2], (2, 0),
                                           value=NEG), NEG)
        new = _LogAddExp.apply(_LogAddExp.apply(alpha, a_m1), a_m2) + e
        new = torch.where(valid_s, new, NEG)
        alpha = torch.where((t < in_lens)[:, None], new, alpha)
    end1 = alpha.gather(1, (2 * lab_lens)[:, None])
    end2 = alpha.gather(1, torch.clamp_min(2 * lab_lens - 1, 0)[:, None])
    loss = -_LogAddExp.apply(end1, end2)
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp_min(in_lens, 1)[:, None].to(loss.dtype)
    return {"Loss": loss}


@register_op("edit_distance")
def _edit_distance(ctx, ins, attrs):
    """The Levenshtein distance of each row of Hyps [B, H] to Refs [B, R]
    within their lengths, normalised by the reference length unless
    ``normalized`` is False: Out [B, 1] fp32, SequenceNum [B] as an
    int64 [1] (int32 in the JAX package without x64).  The DP runs a
    loop over H on the device; each row's min-plus recurrence along R
    (c[j] = min(c[j - 1] + 1, a[j])) is a running minimum,
    c[j] = j + min(c[-1] + 1, min over k <= j of (a[k] - k)), exact in
    integers."""
    hyp, ref = _labels(ins["Hyps"][0]), _labels(ins["Refs"][0])
    B, H = hyp.shape
    R = ref.shape[1]
    dev = hyp.device
    h_lens = ctx.get_len(ctx.op.inputs["Hyps"][0])
    r_lens = ctx.get_len(ctx.op.inputs["Refs"][0])
    h_lens = torch.full((B,), H, dtype=torch.int64, device=dev) \
        if h_lens is None else h_lens.to(torch.int64)
    r_lens = torch.full((B,), R, dtype=torch.int64, device=dev) \
        if r_lens is None else r_lens.to(torch.int64)
    j = torch.arange(R, device=dev)
    prev = torch.arange(R + 1, device=dev).expand(B, R + 1)
    for i in range(H):
        first = torch.full((B, 1), i + 1, dtype=torch.int64, device=dev)
        sub = prev[:, :-1] + (ref != hyp[:, i:i + 1]).to(torch.int64)
        a = torch.minimum(prev[:, 1:] + 1, sub)
        run = torch.cummin(a - j, dim=1).values
        new = torch.cat([first, j + torch.minimum(first + 1, run)], dim=1)
        prev = torch.where((i < h_lens)[:, None], new, prev)
    d = prev.gather(1, r_lens[:, None]).to(torch.float32)
    if attrs.get("normalized", True):
        d = d / torch.clamp_min(r_lens, 1)[:, None].to(torch.float32)
    return {"Out": d, "SequenceNum": torch.full((1,), B, dtype=torch.int64,
                                                device=dev)}


@register_op("chunk_eval")
def _chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 by the JAX package's simplified
    IOB count (ROADMAP Queue C): a chunk starts at a tag that is even
    and below 2 * num_chunk_types, a correct chunk is a label start
    whose inferred tag is equal, within Label's lengths;
    ``chunk_scheme`` is not read.  The three counts are int64 [1] (int32
    in the JAX package without x64)."""
    inf, label = _labels(ins["Inference"][0]), _labels(ins["Label"][0])
    B, T = label.shape
    lens = ctx.get_len(ctx.op.inputs["Label"][0])
    if lens is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=label.device)
    m = _mask(lens, T, torch.float32)
    n_types = attrs.get("num_chunk_types", 1)

    def starts(tags):
        return ((tags % 2 == 0) & (tags < 2 * n_types)).to(torch.float32)

    lab_chunks = (starts(label) * m).sum()
    inf_chunks = (starts(inf) * m).sum()
    correct = (starts(label) * (inf == label).to(torch.float32) * m).sum()
    prec = correct / torch.clamp_min(inf_chunks, 1.0)
    rec = correct / torch.clamp_min(lab_chunks, 1.0)
    f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-6)
    return {"Precision": prec.reshape(1), "Recall": rec.reshape(1),
            "F1-Score": f1.reshape(1),
            "NumInferChunks": inf_chunks.to(torch.int64).reshape(1),
            "NumLabelChunks": lab_chunks.to(torch.int64).reshape(1),
            "NumCorrectChunks": correct.to(torch.int64).reshape(1)}


@register_op("copy_len")
def _copy_len(ctx, ins, attrs):
    """Forward the ``@LEN`` (and nested ``@LEN2``) companions of X to
    Out; no tensor is produced."""
    name_in = ctx.op.inputs["X"][0]
    name_out = ctx.op.outputs["Out"][0]
    lens = ctx.get_len(name_in)
    if lens is not None:
        ctx.set_len(name_out, lens)
    lens2 = ctx.get_len2(name_in)
    if lens2 is not None:
        ctx.set_len2(name_out, lens2)
    return {}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo, dim_ok,  # noqa: E402
                                    first, no_outputs)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn("copy_len")(no_outputs())


@register_shape_fn("linear_chain_crf")
def _linear_chain_crf_shape(op, ins, attrs):
    em, trans = first(ins, "Emission"), first(ins, "Transition")
    if em.shape is not None and trans.shape is not None and \
            len(em.shape) == 3 and len(trans.shape) == 2 and \
            em.shape[-1] >= 0 and trans.shape[-1] >= 0:
        d = em.shape[-1]
        if trans.shape[-1] != d or (trans.shape[0] >= 0
                                    and trans.shape[0] != d + 2):
            raise ShapeError(
                f"linear_chain_crf: Transition {list(trans.shape)} must be "
                f"[D+2, D] for Emission D={d}")
    b = em.shape[0] if em.shape is not None else -1
    d = em.shape[-1] if em.shape is not None else -1
    return {"LogLikelihood": VarInfo((b, 1), em.dtype),
            "Alpha": VarInfo((b, d), em.dtype),
            "EmissionExps": em, "TransitionExps": trans}


@register_shape_fn("crf_decoding")
def _crf_decoding_shape(op, ins, attrs):
    em = first(ins, "Emission")
    if em.shape is None or len(em.shape) < 2:
        return {"ViterbiPath": VarInfo(None, "int64")}
    return {"ViterbiPath": VarInfo(em.shape[:2], "int64")}


@register_shape_fn("warpctc")
def _warpctc_shape(op, ins, attrs):
    logits = first(ins, "Logits")
    b = logits.shape[0] if logits.shape is not None else -1
    return {"Loss": VarInfo((b, 1), logits.dtype)}


@register_shape_fn("edit_distance")
def _edit_distance_shape(op, ins, attrs):
    hyp = first(ins, "Hyps")
    b = hyp.shape[0] if hyp.shape is not None else -1
    return {"Out": VarInfo((b, 1), "float32"),
            "SequenceNum": VarInfo((1,), "int64")}


@register_shape_fn("chunk_eval")
def _chunk_eval_shape(op, ins, attrs):
    inf, lab = first(ins, "Inference"), first(ins, "Label")
    if inf.shape is not None and lab.shape is not None and \
            not dim_ok(inf.shape[0], lab.shape[0]):
        raise ShapeError(
            f"chunk_eval: batch mismatch Inference {list(inf.shape)} vs "
            f"Label {list(lab.shape)}")
    f = VarInfo((1,), "float32")
    i = VarInfo((1,), "int64")
    return {"Precision": f, "Recall": f, "F1-Score": f,
            "NumInferChunks": i, "NumLabelChunks": i,
            "NumCorrectChunks": i}


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop): the CRF ops keep the
# batch sharding of their emissions; copy_len is a metadata marker (it
# forwards a @LEN companion and rebinds no value).
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import shard_batch_only, shard_noop  # noqa: E402
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("copy_len")(shard_noop())
register_shard_fn("crf_decoding")(
    shard_batch_only("Emission", out="ViterbiPath"))
register_shard_fn("linear_chain_crf")(
    shard_batch_only("Emission", out="LogLikelihood",
                     also=("EmissionExps", "Alpha")))
