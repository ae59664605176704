"""NN ops on the ResNet serving path (counterpart of ``conv2d``,
``pool2d``, ``batch_norm`` and ``softmax`` in ``paddle_tpu/ops/nn_ops.py``).

Data layout is NCHW, as in the JAX package.  Eligible 1x1 convolutions
go to the hand-written kernel (``ops/conv1x1.py``); the rest are plain
PyTorch calls, where the JAX package left them to XLA.  The JAX
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
    if _conv1x1_kernel_wanted(ctx, attrs) and conv1x1.conv1x1_eligible(
            tuple(x.shape), tuple(w.shape), strides, pads, dil, groups):
        return {"Output": conv1x1.conv2d_1x1(x, w, strides)}
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
    if attrs.get("ceil_mode", False):
        raise NotImplementedError(
            "pool2d ceil_mode=True is not ported yet (the JAX package pads "
            "right/bottom; no ported model uses it)")
    ks = _pair(attrs.get("ksize", [2, 2]))
    st = _pair(attrs.get("strides", [1, 1]))
    pd = _pair(attrs.get("paddings", [0, 0]))
    if ptype == "max":
        return {"Out": F.max_pool2d(x, ks, st, pd)}
    # exclusive: padded taps are left out of the divisor
    return {"Out": F.avg_pool2d(
        x, ks, st, pd,
        count_include_pad=not attrs.get("exclusive", True))}


@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """Inference batch norm on the running statistics, folded into one
    per-channel scale and shift applied in x's dtype (``nn_ops.py:
    296-302`` of the JAX package).  Outputs mirror the reference (Y,
    MeanOut, VarianceOut, SavedMean, SavedVariance)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    use_global = attrs.get("use_global_stats")
    if use_global is None:
        use_global = is_test
    if not use_global:
        raise NotImplementedError(
            "batch_norm on batch statistics (training) is not ported yet; "
            "run with is_test=True")
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    use_mean = mean.float()
    inv = torch.rsqrt(var.float() + eps)
    eff_scale = scale.float() * inv
    eff_shift = bias.float() - use_mean * eff_scale
    y = (x * eff_scale.reshape(bshape).to(x.dtype)
         + eff_shift.reshape(bshape).to(x.dtype))
    return {"Y": y, "MeanOut": mean, "VarianceOut": var,
            "SavedMean": use_mean, "SavedVariance": inv}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))}
