"""NN ops (counterpart of ``paddle_tpu/ops/nn_ops.py``: every op it
registers, with its aliases ``depthwise_conv2d``, ``pool2d_with_index``
and ``block_expand``).

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


@register_op("conv2d", "depthwise_conv2d")
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
        hi = tuple(p + e for p, e in zip(pd, extra))
        return {"Out": _pool_padded(x, ptype, ks, st, pd, hi, exclusive)}
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


def _pool_padded(x, ptype, ks, st, lo, hi, exclusive):
    """Max or average pooling over the trailing ``len(ks)`` dims of x
    padded by ``lo`` before and ``hi`` after each (any width, unlike
    torch's pooling padding): max over -inf padding; the average
    divides by the taps inside x when ``exclusive``, else by the whole
    window.  The JAX package's ``lax.reduce_window`` forms
    (``nn_ops.py:132-204``)."""
    nd = len(ks)
    pads = []
    for a, b in zip(reversed(lo), reversed(hi)):
        pads += [a, b]
    pool = {2: (F.max_pool2d, F.avg_pool2d),
            3: (F.max_pool3d, F.avg_pool3d)}[nd]
    if ptype == "max":
        return pool[0](F.pad(x, pads, value=float("-inf")), ks, st)
    window = 1
    for k in ks:
        window *= k
    # the sums in fp32 (or wider), rounded once to x's dtype
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    total = pool[1](F.pad(xf, pads), ks, st) * window
    if not exclusive:
        return (total / window).to(x.dtype)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=xf.dtype,
                      device=x.device)
    taps = pool[1](F.pad(ones, pads), ks, st) * window
    return (total / taps).to(x.dtype)


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


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """Filter [C_in, C_out, kh, kw] (``nn_ops.py:96-114``, one group):
    the gradient of a convolution with respect to its input, output
    (H - 1) * s - 2 p + d (k - 1) + 1."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": F.conv_transpose2d(
        x, w, stride=_pair(attrs.get("strides", [1, 1])),
        padding=_pair(attrs.get("paddings", [0, 0])),
        dilation=_pair(attrs.get("dilations", [1, 1])))}


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """NCDHW input, Filter [M, C/g, kd, kh, kw]."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": F.conv3d(
        x, w, stride=tuple(attrs.get("strides", [1, 1, 1])),
        padding=tuple(attrs.get("paddings", [0, 0, 0])),
        dilation=tuple(attrs.get("dilations", [1, 1, 1])),
        groups=int(attrs.get("groups", 1) or 1))}


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    """NCDHW max or average pooling (``nn_ops.py:180-204``): strides
    default to the window, and the average leaves padded taps out of
    its divisor."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        ks = tuple(x.shape[2:])
        st, pd = ks, (0, 0, 0)
    else:
        ks = tuple(attrs.get("ksize", [2, 2, 2]))
        st = tuple(attrs.get("strides", ks))
        pd = tuple(attrs.get("paddings", [0, 0, 0]))
    return {"Out": _pool_padded(x, ptype, ks, st, pd, pd, exclusive=True)}


@register_op("max_pool2d_with_index", "pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    """Max pooling with the flat H*W input index of each maximum (for
    ``unpool``), int64.  As the JAX lowering's patch extraction, padded
    taps hold zeros, and the first of tied maxima in window order wins."""
    x = ins["X"][0]
    ks = _pair(attrs.get("ksize", [2, 2]))
    st = _pair(attrs.get("strides", ks))
    pd = _pair(attrs.get("paddings", [0, 0]))
    n, c, h, w = x.shape
    oh = (h + 2 * pd[0] - ks[0]) // st[0] + 1
    ow = (w + 2 * pd[1] - ks[1]) // st[1] + 1
    patches = F.unfold(x, ks, stride=st, padding=pd).reshape(
        n, c, ks[0] * ks[1], oh, ow)
    out = torch.amax(patches, dim=2)
    arg = torch.argmax(patches, dim=2)
    ph, pw = arg // ks[1], arg % ks[1]
    base_h = (torch.arange(oh, device=x.device) * st[0]
              - pd[0])[None, None, :, None]
    base_w = (torch.arange(ow, device=x.device) * st[1]
              - pd[1])[None, None, None, :]
    idx = (base_h + ph) * w + (base_w + pw)
    return {"Out": out, "Mask": idx.to(torch.int64)}


@register_op("unpool")
def _unpool(ctx, ins, attrs):
    """Scatter X's values to the flat positions of Indices in a zero
    [N, C, uh, uw] output (``unpool_size``, else ``ksize`` times X's
    size)."""
    x, idx = ins["X"][0], ins["Indices"][0]
    n, c, oh, ow = x.shape
    uh, uw = attrs["unpool_size"] if "unpool_size" in attrs else (
        attrs["ksize"][0] * oh, attrs["ksize"][1] * ow)
    flat = torch.zeros((n, c, uh * uw), dtype=x.dtype, device=x.device)
    out = flat.scatter(2, idx.reshape(n, c, -1).to(torch.int64),
                       x.reshape(n, c, -1))
    return {"Out": out.reshape(n, c, uh, uw)}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Normalize over dims ``begin_norm_axis``.. (``nn_ops.py:307-323``),
    then Scale and Bias (flattened over those dims).  Mean and variance
    (biased) are taken in the operand's dtype, as ``jnp.mean`` and
    ``jnp.var`` return them: bf16 under AMP."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = (1,) * begin + tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(shape)
    return {"Y": y, "Mean": mean.reshape(x.shape[:begin]),
            "Variance": var.reshape(x.shape[:begin])}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": torch.log_softmax(ins["X"][0],
                                     dim=attrs.get("axis", -1))}


@register_op("softmax_with_cross_entropy")
def _softmax_with_ce(ctx, ins, attrs):
    """Logits -> log_softmax -> the loss against hard (int ids, [..., 1]
    or [...]) or soft labels, [..., 1]; ``Softmax`` is exp(log_softmax),
    in the logits' dtype (``nn_ops.py:354-366``)."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        lab = label.long()
        if lab.dim() == logits.dim():
            lab = lab.squeeze(-1)
        loss = -torch.gather(logp, -1, lab.unsqueeze(-1))
    return {"Softmax": torch.exp(logp), "Loss": loss}


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    """The max over each group of ``groups`` consecutive channels."""
    x = ins["X"][0]
    g = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": torch.amax(x.reshape(n, c // g, g, h, w), dim=2)}


def _triangle_weights(size_in, size_out, device):
    """[size_in, size_out] weights of ``jax.image.resize``'s bilinear
    (triangle) kernel with antialiasing (``compute_weight_mat``): half-pixel
    centres, the kernel widened by the scale when downsampling, each
    column normalized, samples outside the input zeroed."""
    scale = size_out / size_in
    inv = 1.0 / scale
    width = max(inv, 1.0)
    f = torch.float32
    sample = (torch.arange(size_out, dtype=f, device=device) + 0.5) * inv \
        - 0.5
    x = (sample[None, :] - torch.arange(size_in, dtype=f,
                                        device=device)[:, None]).abs() / width
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    """Resize H and W to (out_h, out_w) as ``jax.image.resize(...,
    "bilinear")`` does (``nn_ops.py:413-421``): a weight matrix a
    resized dim contracted with x; an unchanged dim is left alone."""
    x = ins["X"][0]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    out = xf
    for dim, size in ((2, attrs["out_h"]), (3, attrs["out_w"])):
        if x.shape[dim] == size:
            continue
        # the weights in x's dtype, as the JAX op casts them; the
        # contraction accumulates in fp32 and rounds once
        w = _triangle_weights(x.shape[dim], size, x.device).to(x.dtype)
        out = torch.movedim(torch.movedim(out, dim, -1) @ w.to(xf.dtype),
                            -1, dim)
    return {"Out": out.to(x.dtype)}


@register_op("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    """Y padded at the end of each dim up to X's shape with
    ``pad_value``."""
    x, y = ins["X"][0], ins["Y"][0]
    pads = []
    for xs, ys in zip(reversed(x.shape), reversed(y.shape)):
        pads += [0, xs - ys]
    return {"Out": F.pad(y, pads, value=attrs.get("pad_value", 0.0))}


@register_op("spp")
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling (``nn_ops.py:431-446``): level l pools
    into 2^l x 2^l bins (window ceil(H / bins), centred padding, the
    average over the whole window), flattened and concatenated."""
    x = ins["X"][0]
    levels = attrs.get("pyramid_height", 3)
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        o = _pool_padded(x, ptype, (kh, kw), (kh, kw), (ph, pw), (ph, pw),
                         exclusive=False)
        outs.append(o.reshape(n, -1))
    return {"Out": torch.cat(outs, dim=1)}


@register_op("im2sequence", "block_expand")
def _im2sequence(ctx, ins, attrs):
    """Image patches -> a sequence [N, oh * ow, C * kh * kw] (v1
    BlockExpandLayer), zero padded.  Like the JAX op it sets no ``@LEN``:
    every row has oh * ow steps."""
    x = ins["X"][0]
    ks = _pair(attrs.get("kernels", attrs.get("block", [1, 1])))
    st = _pair(attrs.get("strides", [1, 1]))
    pd = _pair(attrs.get("paddings", [0, 0]))
    return {"Out": F.unfold(x, ks, stride=st, padding=pd).transpose(1, 2)}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer) — the InferShape analogs
# of conv_op.cc / pool_op.cc / batch_norm_op.cc etc.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo,  # noqa: E402
                                    conv_out_dim, dim_ok, first, mirror,
                                    same_as)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn("softmax", "log_softmax")(same_as("X"))
register_shape_fn("pad_constant_like")(same_as("X"))


@register_shape_fn("conv2d", "depthwise_conv2d")
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


@register_shape_fn("conv2d_transpose")
def _conv2d_transpose_shape(op, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Filter")
    if x.shape is None or w.shape is None:
        return {"Output": VarInfo(None, x.dtype)}
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    dil = _pair(attrs.get("dilations", [1, 1]))
    n, c, h, wd = x.shape
    ci, co, kh, kw = w.shape
    if c >= 0 and ci >= 0 and c != ci:
        raise ShapeError(
            f"conv2d_transpose: input channels {c} != Filter C_in {ci}")

    def _out(size, k, p, s, d):
        if size < 0:
            return -1
        return (size - 1) * s - 2 * p + d * (k - 1) + 1

    return {"Output": VarInfo(
        (n, co, _out(h, kh, pads[0], strides[0], dil[0]),
         _out(wd, kw, pads[1], strides[1], dil[1])), x.dtype)}


@register_shape_fn("conv3d")
def _conv3d_shape(op, ins, attrs):
    x, w = first(ins, "Input"), first(ins, "Filter")
    if x.shape is None or w.shape is None:
        return {"Output": VarInfo(None, x.dtype)}
    strides = tuple(attrs.get("strides", [1, 1, 1]))
    pads = tuple(attrs.get("paddings", [0, 0, 0]))
    dil = tuple(attrs.get("dilations", [1, 1, 1]))
    n = x.shape[0]
    o = w.shape[0]
    dims = tuple(conv_out_dim(x.shape[2 + i], w.shape[2 + i], pads[i],
                              strides[i], dil[i]) for i in range(3))
    return {"Output": VarInfo((n, o) + dims, x.dtype)}


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


@register_shape_fn("max_pool2d_with_index", "pool2d_with_index")
def _pool2d_with_index_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x, "Mask": VarInfo(None, "int64")}
    a = dict(attrs)
    a.setdefault("strides", a.get("ksize", [2, 2]))
    # the patch-extraction lowering always floors
    a["ceil_mode"] = False
    shape = _pool2d_out_shape(x, a)
    return {"Out": x.with_shape(shape), "Mask": VarInfo(shape, "int64")}


@register_shape_fn("pool3d")
def _pool3d_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    if attrs.get("global_pooling", False):
        return {"Out": x.with_shape(x.shape[:2] + (1, 1, 1))}
    ks = list(attrs.get("ksize", [2, 2, 2]))
    strides = list(attrs.get("strides", ks))
    pads = list(attrs.get("paddings", [0, 0, 0]))
    dims = tuple(conv_out_dim(x.shape[2 + i], ks[i], pads[i], strides[i])
                 for i in range(3))
    return {"Out": x.with_shape(x.shape[:2] + dims)}


@register_shape_fn("unpool")
def _unpool_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    n, c, oh, ow = x.shape
    if "unpool_size" in attrs:
        uh, uw = attrs["unpool_size"]
    else:
        uh, uw = attrs["ksize"][0] * oh, attrs["ksize"][1] * ow
    return {"Out": x.with_shape((n, c, uh, uw))}


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


@register_shape_fn("layer_norm")
def _layer_norm_shape(op, ins, attrs):
    x = first(ins, "X")
    res = {"Y": x}
    if x.shape is not None:
        begin = attrs.get("begin_norm_axis", 1)
        stat = VarInfo(x.shape[:begin], x.dtype)
        res["Mean"] = stat
        res["Variance"] = stat
    return res


@register_shape_fn("cross_entropy")
def _cross_entropy_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Y": x}
    return {"Y": x.with_shape(x.shape[:-1] + (1,))}


@register_shape_fn("softmax_with_cross_entropy")
def _softmax_ce_shape(op, ins, attrs):
    logits, label = first(ins, "Logits"), first(ins, "Label")
    if logits.shape is None:
        return {"Softmax": logits, "Loss": VarInfo(None, logits.dtype)}
    if label.shape is not None and not attrs.get("soft_label", False):
        if not dim_ok(label.shape[0], logits.shape[0]):
            raise ShapeError(
                f"softmax_with_cross_entropy: batch mismatch Logits "
                f"{list(logits.shape)} vs Label {list(label.shape)}")
    return {"Softmax": logits,
            "Loss": logits.with_shape(logits.shape[:-1] + (1,))}


@register_shape_fn("dropout")
def _dropout_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": x, "Mask": x}


@register_shape_fn("lrn")
def _lrn_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": x, "MidOut": x}

@register_shape_fn("maxout")
def _maxout_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    g = attrs["groups"]
    n, c, h, w = x.shape
    if c >= 0 and c % g:
        raise ShapeError(f"maxout: channels {c} not divisible by groups {g}")
    return {"Out": x.with_shape((n, -1 if c < 0 else c // g, h, w))}


@register_shape_fn("bilinear_interp")
def _bilinear_interp_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    return {"Out": x.with_shape(x.shape[:2] + (attrs["out_h"],
                                               attrs["out_w"]))}


@register_shape_fn("spp")
def _spp_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    n, c = x.shape[0], x.shape[1]
    bins = sum(4 ** lv for lv in range(attrs.get("pyramid_height", 3)))
    return {"Out": x.with_shape((n, -1 if c < 0 else c * bins))}


@register_shape_fn("im2sequence", "block_expand")
def _im2sequence_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    kh, kw = _pair(attrs.get("kernels", attrs.get("block", [1, 1])))
    sh, sw = _pair(attrs.get("strides", [1, 1]))
    ph, pw = _pair(attrs.get("paddings", [0, 0]))
    n, c, h, wd = x.shape
    oh = conv_out_dim(h, kh, ph, sh)
    ow = conv_out_dim(wd, kw, pw, sw)
    t = -1 if oh < 0 or ow < 0 else oh * ow
    d = -1 if c < 0 else c * kh * kw
    return {"Out": x.with_shape((n, t, d))}



# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  Convolutions follow
# batch/output-channel sharding, normalizations and pointwise heads are
# shape-preserving, losses keep the batch dim only.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (ShardConflict, first_in,  # noqa: E402
                                   shard_batch_only, shard_conv2d,
                                   shard_same_as)
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("conv2d", "depthwise_conv2d")(shard_conv2d())
register_shard_fn("softmax", "log_softmax", "lrn")(shard_same_as("X"))
register_shard_fn("dropout")(shard_same_as("X", also=("Mask",)))
register_shard_fn("cross_entropy")(shard_batch_only("X", out="Y"))


@register_shard_fn("pool2d", "pool3d", "max_pool2d_with_index",
                   "pool2d_with_index")
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


@register_shard_fn("layer_norm")
def _layer_norm_shard(op, ins, attrs):
    x = first_in(ins, "X")
    if x.spec is None:
        return {}
    begin = attrs.get("begin_norm_axis", 1)
    res = {"Y": x.spec}
    if op.outputs.get("Mean"):
        res["Mean"] = x.spec[:begin]
    if op.outputs.get("Variance"):
        res["Variance"] = x.spec[:begin]
    return res


@register_shard_fn("softmax_with_cross_entropy")
def _softmax_ce_shard(op, ins, attrs):
    logits = first_in(ins, "Logits")
    if logits.spec is None:
        return {}
    return {"Softmax": logits.spec, "Loss": (logits.entry(0), None)}
