"""Embedding and sampled-output ops (counterpart of
``paddle_tpu/ops/embedding_ops.py``): ``lookup_table``,
``lookup_table_sparse``, ``nce`` and ``hierarchical_sigmoid``
(``hsigmoid``).  The gather's gradient is autograd's scatter-add (an
accumulating ``index_put_``): into a dense [V, D] gradient for
``lookup_table`` (``is_sparse`` changes nothing), into the [bucket, D]
rows feed for ``lookup_table_sparse``.  ``nce`` draws its negatives from
the op's generator (``ExecContext.generator``; it is one of the
executor's ``RANDOM_OPS``), so a captured step draws anew each replay."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """W [V, D]; Ids [..., 1] or [...] of ints -> Out [..., D]; the rows
    of ids equal to ``padding_idx`` (when >= 0) are zeros."""
    w, ids = ins["W"][0], ins["Ids"][0].long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    pad = attrs.get("padding_idx", None)
    if pad is None or pad < 0:
        return {"Out": w[ids]}
    is_pad = ids == pad
    out = w[torch.where(is_pad, 0, ids)]
    return {"Out": out.masked_fill(is_pad[..., None], 0)}


@register_op("lookup_table_sparse")
def _lookup_table_sparse(ctx, ins, attrs):
    """A host-resident table's gather (``paddle_tpu_torch.sparse``): the
    ``SparseSession`` rim feeds ``Rows``, the dense [bucket, D] rows the
    batch touches, and ``Inverse``, each id position's slot in them, so
    the op is a gather of rows.  The gradient of ``Rows`` is fetched as
    ``<rows>@GRAD`` and pushed back to the host table.  ``Ids`` is an
    input for the graph's data dependency only (the session derives
    ``Inverse`` from it on the host)."""
    rows, inv = ins["Rows"][0], ins["Inverse"][0]
    return {"Out": rows[inv.long()]}


def _logistic_ce(logits, targets):
    """The sigmoid cross entropy of ``logits`` against 0/1 ``targets``,
    in the stable form max(z, 0) - z * y + log1p(exp(-|z|))."""
    return torch.clamp_min(logits, 0) - logits * targets + \
        torch.log1p(torch.exp(-torch.abs(logits)))


@register_op("nce")
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation with uniform negatives: Input [B, D],
    Label [B, 1] (one true class), Weight [V, D], Bias [V] optional;
    ``num_neg_samples`` k negatives a row drawn uniformly from
    [0, num_total_classes), the true class among them possibly (the JAX
    package's draw, ROADMAP Queue C).  SampleLabels [B, 1 + k] int64
    (the label first), SampleLogits their logits less log(k / V), Cost
    [B, 1] the summed logistic losses (the true class's target 1)."""
    x, w = ins["Input"][0], ins["Weight"][0]
    label = ins["Label"][0].to(torch.int64).reshape(-1)
    bias = ins["Bias"][0] if ins.get("Bias") else None
    k = attrs.get("num_neg_samples", 10)
    V = attrs.get("num_total_classes", w.shape[0])
    B = x.shape[0]
    neg = torch.randint(0, V, (B, k), generator=ctx.generator(),
                        device=x.device)
    samples = torch.cat([label[:, None], neg], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, w[samples])
    if bias is not None:
        logits = logits + bias.reshape(-1)[samples]
    logits = logits - math.log(k / V)
    # fp32 targets, as the JAX package's jnp.ones/zeros: a bf16 cost is
    # computed in fp32
    targets = torch.cat([torch.ones((B, 1), device=x.device),
                         torch.zeros((B, k), device=x.device)], dim=1)
    cost = _logistic_ce(logits, targets).sum(dim=1, keepdim=True)
    return {"Cost": cost, "SampleLogits": logits, "SampleLabels": samples}


@register_op("hierarchical_sigmoid", "hsigmoid")
def _hsigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over a complete binary tree of
    ``num_classes`` leaves in heap layout (HierarchicalSigmoidLayer):
    leaf label + num_classes - 1, walked up ``depth`` =
    (num_classes - 1).bit_length() levels, each level's node a row of W
    [num_classes - 1, D] (and of Bias) and its side the target bit; the
    levels above the root masked.  Out [B, 1] the summed logistic
    losses, PreOut [B, depth] the node logits."""
    x, w = ins["X"][0], ins["W"][0]
    label = ins["Label"][0].to(torch.int64).reshape(-1)
    bias = ins["Bias"][0] if ins.get("Bias") else None
    num_classes = int(attrs["num_classes"])
    depth = max(1, (num_classes - 1).bit_length())
    node = label + num_classes - 1
    nodes, bits = [], []
    for _ in range(depth):
        bits.append(node % 2)
        node = torch.div(node - 1, 2, rounding_mode="floor")
        nodes.append(node)
    nodes = torch.stack(nodes, dim=1)
    bits = torch.stack(bits, dim=1).to(x.dtype)
    valid = (nodes >= 0) & (nodes < num_classes - 1)
    safe = torch.clamp(nodes, 0, num_classes - 2)
    logits = torch.einsum("bd,bkd->bk", x, w[safe])
    if bias is not None:
        logits = logits + bias.reshape(-1)[safe]
    cost = (_logistic_ce(logits, bits) * valid.to(x.dtype)).sum(
        dim=1, keepdim=True)
    return {"Out": cost, "PreOut": logits}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer).
# ---------------------------------------------------------------------------
import numpy as _np  # noqa: E402

from ..analysis.shape_infer import (ShapeError, VarInfo, first,  # noqa: E402
                                    squeeze_ids)
from ..core.registry import register_shape_fn  # noqa: E402


@register_shape_fn("lookup_table")
def _lookup_table_shape(op, ins, attrs):
    w, ids = first(ins, "W"), first(ins, "Ids")
    if ids.dtype is not None and ids.dtype.kind == "f":
        raise ShapeError(
            f"lookup_table: Ids must be integral, got {ids.dtype.name}")
    s = squeeze_ids(ids)
    if s is None or w.shape is None:
        return {"Out": VarInfo(None, w.dtype)}
    return {"Out": VarInfo(s + (w.shape[-1],), w.dtype)}


@register_shape_fn("lookup_table_sparse")
def _lookup_table_sparse_shape(op, ins, attrs):
    rows, inv = first(ins, "Rows"), first(ins, "Inverse")
    if inv.dtype is not None and inv.dtype.kind == "f":
        raise ShapeError(
            f"lookup_table_sparse: Inverse must be integral, got "
            f"{inv.dtype.name}")
    dim = int(attrs.get("dim", rows.shape[-1] if rows.shape else -1))
    if inv.shape is None:
        return {"Out": VarInfo(None, rows.dtype)}
    return {"Out": VarInfo(tuple(inv.shape) + (dim,), rows.dtype)}


@register_shape_fn("nce")
def _nce_shape(op, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Weight")
    if x.shape is not None and w.shape is not None and \
            x.shape[-1] >= 0 and w.shape[-1] >= 0 and \
            x.shape[-1] != w.shape[-1]:
        raise ShapeError(
            f"nce: Input dim {x.shape[-1]} != Weight dim {w.shape[-1]}")
    b = x.shape[0] if x.shape is not None else -1
    k = attrs.get("num_neg_samples", 10)
    return {"Cost": VarInfo((b, 1), _np.float32 if x.dtype is None
                            else x.dtype),
            "SampleLogits": VarInfo((b, 1 + k), x.dtype),
            "SampleLabels": VarInfo((b, 1 + k), "int64")}


@register_shape_fn("hierarchical_sigmoid", "hsigmoid")
def _hsigmoid_shape(op, ins, attrs):
    x = first(ins, "X")
    b = x.shape[0] if x.shape is not None else -1
    num_classes = attrs.get("num_classes")
    depth = (int(num_classes) - 1).bit_length() \
        if isinstance(num_classes, int) else -1
    return {"Out": VarInfo((b, 1), x.dtype),
            "PreOut": VarInfo((b, depth), x.dtype)}


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  A vocab-sharded table
# is a masked partial gather + all-reduce; the output rides the Ids'
# batch sharding either way, with the emb dim following the table's
# column split.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (first_in,  # noqa: E402
                                   shard_batch_only, squeeze_spec_ids)
from ..core.registry import register_shard_fn  # noqa: E402


@register_shard_fn("lookup_table")
def _lookup_table_shard(op, ins, attrs):
    w, ids = first_in(ins, "W"), first_in(ins, "Ids")
    if w.spec is None and ids.spec is None:
        return {}
    lead = squeeze_spec_ids(ids)
    return {"Out": lead + (w.entry(-1),)}


@register_shard_fn("lookup_table_sparse")
def _lookup_table_sparse_shard(op, ins, attrs):
    # The table is HOST-side; the planner sees only the dense gathered
    # rows as a device tensor.  Out follows the inverse index's (batch)
    # sharding with the emb dim riding the rows feed's column split
    # (normally replicated — the rows feed is host-built per batch).
    rows, inv = first_in(ins, "Rows"), first_in(ins, "Inverse")
    if rows.spec is None and inv.spec is None:
        return {}
    lead = tuple(inv.spec) if inv.spec is not None else (None,)
    return {"Out": lead + (rows.entry(-1),)}


register_shard_fn("nce", "hierarchical_sigmoid", "hsigmoid")(
    shard_batch_only("Input", out="Cost", fallbacks=("X",),
                     also=("Out", "PreOut", "SampleLogits",
                           "SampleLabels")))
