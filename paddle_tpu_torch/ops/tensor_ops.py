"""Tensor-creation ops of the startup program (counterpart of the
``fill_constant`` / ``uniform_random`` / ``gaussian_random`` lowerings in
``paddle_tpu/ops/tensor_ops.py``).  Random ops draw from a
``torch.Generator`` the executor seeds per op (``ExecContext.generator``);
the numbers differ from JAX's, the distributions do not."""
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
