"""NN ops of the ported paths (counterpart of ``conv2d``, ``pool2d``,
``batch_norm``, ``softmax``, ``cross_entropy``, ``dropout`` and ``lrn``
in ``paddle_tpu/ops/nn_ops.py``).

Data layout is NCHW, as in the JAX package.  Eligible 1x1 convolutions
go to the hand-written kernel (``ops/conv1x1.py``): under autograd
through its autograd Function, which runs the kernel for their
gradients too, and otherwise through the custom op
``paddle_tpu_torch::conv2d_1x1``, which ``torch.export`` keeps in an
exported graph and which picks the route at each call's batch; the rest
are plain PyTorch calls, where the JAX package left them to XLA.  The JAX
package's stride-2 space-to-depth stem is an XLA layout trick computing
the same convolution; here the stem is a plain ``conv2d``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from . import conv1x1


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _conv1x1_kernel_wanted(ctx, attrs) -> bool:
    """Tri-state opt-in resolution for the hand-written 1x1 path: per-op
    attr (layers.conv2d(use_pallas=...)) > per-executor setting
    (Executor(conv1x1_pallas=...)) > process flag (conv1x1_pallas)."""
    v = attrs.get("use_pallas")
    if v is None:
        v = getattr(ctx, "conv1x1_pallas", None)
    if v is None:
        from ..flags import get_flag
        v = get_flag("conv1x1_pallas")
    return bool(v)


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """Input [N,C,H,W], Filter [M,C/g,kh,kw]."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    dil = _pair(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1) or 1)
    if _conv1x1_kernel_wanted(ctx, attrs) and conv1x1.conv1x1_static_gate(
            x.shape[1], tuple(w.shape), pads, dil, groups):
        if x.dtype not in conv1x1.KERNEL_DTYPES:
            # the kernels take fp32 and bf16: a float64 step
            # (Executor(compute_dtype="float64")) convolves plainly,
            # counted in routes["dtype"]
            conv1x1.routes["dtype"] += 1
        elif torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            # training: the autograd Function whose backward launches the
            # kernel too, with the whole gate applied here
            if conv1x1.pixels(tuple(x.shape), strides) % 128 == 0:
                return {"Output": conv1x1.conv2d_1x1(x, w, strides)}
        else:
            # inference: one custom op, which a traced graph keeps whole
            # and which applies the P rule at each call's batch
            return {"Output": conv1x1.conv2d_1x1_op(x, w, *strides)}
    return {"Output": F.conv2d(x, w, stride=strides, padding=pads,
                               dilation=dil, groups=groups)}


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    """Max or average pooling, or global pooling over H and W."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    if ptype not in ("max", "avg"):
        raise ValueError(f"pool2d: unknown pooling_type {ptype!r}")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return {"Out": torch.amax(x, dim=(2, 3), keepdim=True)}
        return {"Out": torch.mean(x, dim=(2, 3), keepdim=True)}
    ks = _pair(attrs.get("ksize", [2, 2]))
    st = _pair(attrs.get("strides", [1, 1]))
    pd = _pair(attrs.get("paddings", [0, 0]))
    exclusive = attrs.get("exclusive", True)
    extra = (0, 0)
    if attrs.get("ceil_mode", False):
        extra = tuple(_ceil_extra(x.shape[2 + i], ks[i], pd[i], st[i])
                      for i in range(2))
    if extra != (0, 0):
        return {"Out": _pool2d_ceil(x, ptype, ks, st, pd, extra, exclusive)}
    if ptype == "max":
        return {"Out": F.max_pool2d(x, ks, st, pd)}
    # exclusive: padded taps are left out of the divisor
    return {"Out": F.avg_pool2d(x, ks, st, pd,
                                count_include_pad=not exclusive)}


def _ceil_extra(size, k, p, s):
    """Rows (columns) padded at the bottom (right) so that a partial
    last window yields an output, as the JAX package's ceil mode."""
    rem = (size + 2 * p - k) % s
    return (s - rem) % s if rem else 0


def _pool2d_ceil(x, ptype, ks, st, pd, extra, exclusive):
    """Pooling over x padded by ``pd`` on each side plus ``extra`` at the
    bottom and right (``nn_ops.py:145-167``): max over -inf padding; the
    average divides by the taps inside x when ``exclusive``, else by the
    whole window (padding counts as zeros)."""
    pads = (pd[1], pd[1] + extra[1], pd[0], pd[0] + extra[0])
    if ptype == "max":
        return F.max_pool2d(F.pad(x, pads, value=float("-inf")), ks, st)
    window = ks[0] * ks[1]
    total = F.avg_pool2d(F.pad(x, pads), ks, st) * window
    if not exclusive:
        return total / window
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    taps = F.avg_pool2d(F.pad(ones, pads), ks, st) * window
    return total / taps


@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """Batch norm (``nn_ops.py:248-304`` of the JAX package), folded into
    one per-channel scale and shift applied in x's dtype.

    Training (batch statistics): single-pass fp32 mean and mean of
    squares (float64 for a float64 input), variance clamped at 0;
    gradients flow through both statistics, and the running averages
    (MeanOut/VarianceOut) take detached copies of them, in the running
    stats' dtype.  Inference (``is_test`` or ``use_global_stats``) uses
    the running statistics.  Outputs mirror the reference (Y, MeanOut,
    VarianceOut, SavedMean, SavedVariance = 1/sqrt(var + eps))."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or ctx.is_test
    # v1 use_global_stats tri-state: True forces running stats even in
    # training, False forces batch stats even at test; None follows
    # is_test.  Running stats advance only on training passes.
    use_global = attrs.get("use_global_stats")
    if use_global is None:
        use_global = is_test
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    sdt = torch.promote_types(x.dtype, torch.float32)
    if use_global:
        use_mean, use_var = mean.to(sdt), var.to(sdt)
        mean_out, var_out = mean, var
    else:
        axes = tuple(i for i in range(x.dim()) if i != 1)
        xf = x.to(sdt)
        use_mean = xf.mean(axes)
        use_var = torch.clamp_min((xf * xf).mean(axes) - use_mean * use_mean,
                                  0.0)
        if is_test:
            mean_out, var_out = mean, var
        else:
            mean_out = (momentum * mean + (1.0 - momentum)
                        * use_mean.detach().to(mean.dtype))
            var_out = (momentum * var + (1.0 - momentum)
                       * use_var.detach().to(var.dtype))
    inv = torch.rsqrt(use_var + eps)
    eff_scale = scale.to(sdt) * inv
    eff_shift = bias.to(sdt) - use_mean * eff_scale
    y = (x * eff_scale.reshape(bshape).to(x.dtype)
         + eff_shift.reshape(bshape).to(x.dtype))
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": use_mean, "SavedVariance": inv}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))}


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """cross_entropy_op: X is probabilities [N, D]; hard (int ids [N] or
    [N, 1]) or soft ([N, D]) labels; probabilities clamped at 1e-8 before
    the log.  Out is [N, 1] like the reference."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, eps)),
                          dim=-1, keepdim=True)
    else:
        lab = label.long()
        if lab.dim() == x.dim():
            lab = lab.squeeze(-1)
        picked = torch.gather(x, -1, lab.unsqueeze(-1))
        loss = -torch.log(torch.clamp_min(picked, eps))
    return {"Y": loss}


@register_op("dropout")
def _dropout(ctx, ins, attrs):
    """dropout_op (``nn_ops.py:369-386``): train: x * mask, mask ~
    Bernoulli(1 - p) from the op's generator (``upscale_in_train`` also
    divides by 1 - p); test: x * (1 - p), or x for ``upscale_in_train``.
    The mask draws differ from JAX's; its distribution does not."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    upscale = attrs.get("dropout_implementation", "downgrade_in_infer") \
        == "upscale_in_train"
    if attrs.get("is_test", False) or ctx.is_test:
        out = x if upscale else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(x)}
    u = torch.rand(x.shape, generator=ctx.generator(), device=x.device)
    mask = (u < 1.0 - p).to(x.dtype)
    out = x * mask
    if upscale:
        out = out / (1.0 - p)
    return {"Out": out, "Mask": mask}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """Cross-channel local response normalization (``nn_ops.py:388-401``,
    AlexNet): the sum of squares over ``n`` channels centred on each,
    zero-padded, ``MidOut = k + alpha * sum`` and ``Out = X /
    MidOut ** beta``."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    k = attrs.get("k", 2.0)
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    C = x.shape[1]
    acc = sq[:, 0:C]
    for i in range(1, n):
        acc = acc + sq[:, i:i + C]
    mid = k + alpha * acc
    return {"Out": x / torch.pow(mid, beta), "MidOut": mid}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer) — the InferShape analogs
# of conv_op.cc / pool_op.cc / batch_norm_op.cc etc.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo,  # noqa: E402
                                    conv_out_dim, dim_ok, first, mirror,
                                    same_as)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn("softmax")(same_as("X"))


@register_shape_fn("conv2d")
def _conv2d_shape(op, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Filter")
    if x.shape is None or w.shape is None:
        return {"Output": VarInfo(None, x.dtype)}
    if len(x.shape) != 4 or len(w.shape) != 4:
        raise ShapeError(
            f"conv2d: Input/Filter must be rank-4, got {list(x.shape)} / "
            f"{list(w.shape)}")
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    dil = _pair(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1) or 1)
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    if c >= 0 and cg >= 0 and c != cg * groups:
        raise ShapeError(
            f"conv2d: input channels {c} != Filter C/g {cg} * groups "
            f"{groups}")
    if o >= 0 and groups > 1 and o % groups:
        raise ShapeError(
            f"conv2d: output channels {o} not divisible by groups {groups}")
    oh = conv_out_dim(h, kh, pads[0], strides[0], dil[0])
    ow = conv_out_dim(wd, kw, pads[1], strides[1], dil[1])
    return {"Output": VarInfo((n, o, oh, ow), x.dtype)}


def _pool2d_out_shape(x, attrs):
    if attrs.get("global_pooling", False):
        return x.shape[:2] + (1, 1)
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    ceil = attrs.get("ceil_mode", False)
    return x.shape[:2] + (
        conv_out_dim(x.shape[2], ksize[0], pads[0], strides[0],
                     ceil_mode=ceil),
        conv_out_dim(x.shape[3], ksize[1], pads[1], strides[1],
                     ceil_mode=ceil))


@register_shape_fn("pool2d")
def _pool2d_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    if len(x.shape) != 4:
        raise ShapeError(f"pool2d: X must be rank-4, got {list(x.shape)}")
    return {"Out": x.with_shape(_pool2d_out_shape(x, attrs))}


@register_shape_fn("batch_norm")
def _batch_norm_shape(op, ins, attrs):
    x = first(ins, "X")
    scale = first(ins, "Scale")
    if x.shape is not None and scale.shape is not None and \
            len(x.shape) >= 2 and not dim_ok(x.shape[1], scale.shape[-1]):
        raise ShapeError(
            f"batch_norm: channel dim {x.shape[1]} != Scale size "
            f"{scale.shape[-1]}")
    res = {"Y": x}
    res.update(mirror({"MeanOut": "Mean", "VarianceOut": "Variance",
                       "SavedMean": "Mean", "SavedVariance": "Variance"})(
        op, ins, attrs))
    return res


@register_shape_fn("cross_entropy")
def _cross_entropy_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Y": x}
    return {"Y": x.with_shape(x.shape[:-1] + (1,))}


@register_shape_fn("dropout")
def _dropout_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": x, "Mask": x}


@register_shape_fn("lrn")
def _lrn_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": x, "MidOut": x}


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  Convolutions follow
# batch/output-channel sharding, normalizations and pointwise heads are
# shape-preserving, losses keep the batch dim only.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (ShardConflict, first_in,  # noqa: E402
                                   shard_batch_only, shard_conv2d,
                                   shard_same_as)
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("conv2d")(shard_conv2d())
register_shard_fn("softmax", "lrn")(shard_same_as("X"))
register_shard_fn("dropout")(shard_same_as("X", also=("Mask",)))
register_shard_fn("cross_entropy")(shard_batch_only("X", out="Y"))


@register_shard_fn("pool2d")
def _pool_shard(op, ins, attrs):
    x = first_in(ins, "X")
    if x.spec is None:
        return {}
    if any(x.entry(i) for i in range(2, len(x.spec))):
        raise ShardConflict(
            "pooling input spatially sharded: halo exchange required")
    spec = (x.entry(0), x.entry(1)) + (None,) * (len(x.spec) - 2)
    res = {"Out": spec}
    if op.outputs.get("Mask"):
        res["Mask"] = spec
    return res


@register_shard_fn("batch_norm")
def _batch_norm_shard(op, ins, attrs):
    x = first_in(ins, "X")
    res = {}
    if x.spec is not None:
        res["Y"] = x.spec
    for out_slot, in_slot in (("MeanOut", "Mean"),
                              ("VarianceOut", "Variance"),
                              ("SavedMean", "Mean"),
                              ("SavedVariance", "Variance")):
        v = first_in(ins, in_slot)
        if op.outputs.get(out_slot) and v.spec is not None:
            res[out_slot] = v.spec
    return res
