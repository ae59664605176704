"""Tensor ops (counterpart of the ``fill_constant``,
``fill_constant_batch_size_like``, ``uniform_random``,
``gaussian_random``, ``reshape``, ``squeeze``, ``unsqueeze``,
``concat`` and ``split`` lowerings in ``paddle_tpu/ops/tensor_ops.py``).
Random ops draw from a ``torch.Generator`` the executor keeps per op
and places at each step (``ExecContext.generator``); the numbers differ
from JAX's, the distributions do not."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    dt = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", []))
    return {"Out": torch.full(shape, attrs.get("value", 0.0), dtype=dt,
                              device=ctx.device)}


@register_op("fill_constant_batch_size_like")
def _fill_cbsl(ctx, ins, attrs):
    """The ``shape`` attr with dim ``output_dim_idx`` taken from dim
    ``input_dim_idx`` of Input (a StaticRNN memory's zero start)."""
    ref = ins["Input"][0]
    shape = list(attrs.get("shape", []))
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=to_torch_dtype(attrs.get("dtype",
                                                             "float32")),
                              device=ref.device)}


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    dt = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", []))
    out = torch.randn(shape, generator=ctx.generator(), device=ctx.device,
                      dtype=torch.float32)
    out = out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(dt)}


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    dt = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", []))
    out = torch.empty(shape, device=ctx.device, dtype=torch.float32)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator())
    return {"Out": out.to(dt)}


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    """fluid reshape: a 0 in ``shape`` copies the input's dim, one -1 is
    inferred.  The layer's ``actual_shape`` is not an input of the op
    (as in the JAX package)."""
    x = ins["X"][0]
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape)}


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    """Drop the size-1 ``axes`` (every size-1 dim when none are given)."""
    x = ins["X"][0]
    axes = attrs.get("axes")
    if not axes:
        return {"Out": x.squeeze()}
    axes = {a % x.dim() for a in axes}
    if any(x.shape[a] != 1 for a in axes):
        raise ValueError(f"squeeze: axes {sorted(axes)} of shape "
                         f"{tuple(x.shape)} are not all of size 1")
    return {"Out": x.reshape([s for i, s in enumerate(x.shape)
                              if i not in axes])}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    """Insert size-1 dims at ``axes``, positions in the output's rank
    (``jnp.expand_dims``)."""
    x = ins["X"][0]
    rank = x.dim() + len(attrs["axes"])
    axes = sorted(a % rank for a in attrs["axes"])
    shape = list(x.shape)
    for a in axes:
        shape.insert(a, 1)
    return {"Out": x.reshape(shape)}


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@register_op("split")
def _split(ctx, ins, attrs):
    """Split X along ``axis`` into ``num`` equal parts or into parts of
    the lengths in ``sections`` (``tensor_ops.py:137-150``)."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections")
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs["num"]
    if x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of shape {tuple(x.shape)} "
                         f"does not divide into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}
