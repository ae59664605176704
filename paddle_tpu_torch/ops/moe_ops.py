"""The mixture-of-experts op (counterpart of ``moe`` in
``paddle_tpu/ops/moe_ops.py``) on one card: a gate, GShard's routing
(``parallel/moe.py``), each expert's FFN and the combine, as einsums.

The JAX package also constrains the ``[E, C, D]`` expert batches to its
mesh's ``ep`` axis, where GSPMD inserts the all-to-all; with no mesh
(one card) the same graph runs unconstrained, which is what the port
runs.  The expert-parallel form waits for the multi-GPU item of
``ROADMAP.md``.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..parallel.moe import load_balancing_loss, moe_dispatch


def _gelu(x):
    """``jax.nn.gelu`` (its default tanh form) op by op in x's dtype, its
    constants rounded to that dtype first: in bf16 the JAX package's
    roundings bit for bit (``F.gelu`` rounds once, a bf16 ulp away on
    about 40% of values, which the expert's second product
    magnifies)."""
    def k(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    inner = k(0.7978845608028654) * (x + k(0.044715) * x ** 3)
    return x * (k(0.5) * (k(1.0) + torch.tanh(inner)))


def _sigmoid(x):
    """``jax.nn.sigmoid`` as XLA computes it: 1 / (1 + exp(-x)) op by op
    in x's dtype (``torch.sigmoid`` rounds once, a bf16 ulp away on about
    a third of values)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


_ACTS = {
    "relu": torch.relu,
    "gelu": _gelu,
    "tanh": torch.tanh,
    "sigmoid": _sigmoid,
    "swish": lambda x: x * _sigmoid(x),
}


@register_op("moe")
def _moe(ctx, ins, attrs):
    """X [..., D], GateW [D, E], W1 [E, D, H], W2 [E, H, D]: Out (X's
    shape) and AuxLoss (a float32 scalar).  The gate's softmax is taken
    in fp32 and cast to X's dtype; capacity is max(1, int(capacity_factor
    * top_k * tokens / E))."""
    x = ins["X"][0]
    gate_w = ins["GateW"][0]
    w1 = ins["W1"][0]
    w2 = ins["W2"][0]
    top_k = int(attrs.get("top_k", 2))
    cap_f = float(attrs.get("capacity_factor", 1.25))
    act = _ACTS[attrs.get("activation", "relu")]
    shape = x.shape
    D = shape[-1]
    xt = x.reshape(-1, D)
    T, E = xt.shape[0], gate_w.shape[-1]
    gates = torch.softmax((xt @ gate_w).float(), dim=-1).to(x.dtype)
    capacity = max(1, int(cap_f * top_k * T / E))
    dispatch, combine = moe_dispatch(gates, capacity, top_k)
    aux = load_balancing_loss(gates, dispatch)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    h = act(torch.einsum("ecd,edh->ech", expert_in, w1))
    out_e = torch.einsum("ech,ehd->ecd", h, w2)
    out = torch.einsum("tec,ecd->td", combine, out_e)
    return {"Out": out.reshape(shape),
            "AuxLoss": aux.reshape(()).float()}


# ---------------------------------------------------------------------------
# Static rules (the JAX package's): Out is X's; the aux loss a float32
# scalar.  Shard rule: Out rides X's sharding, the aux loss replicates.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import ShapeError, VarInfo, first  # noqa: E402
from ..analysis.shard_prop import first_in  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)


@register_shape_fn("moe")
def _moe_shape(op, ins, attrs):
    x, gate_w = first(ins, "X"), first(ins, "GateW")
    w1 = first(ins, "W1")
    if x.shape is not None and gate_w.shape is not None and \
            x.shape[-1] >= 0 and gate_w.shape[0] >= 0 and \
            x.shape[-1] != gate_w.shape[0]:
        raise ShapeError(
            f"moe: X feature dim {x.shape[-1]} != GateW rows "
            f"{gate_w.shape[0]}")
    if w1.shape is not None and gate_w.shape is not None and \
            w1.shape[0] >= 0 and gate_w.shape[-1] >= 0 and \
            w1.shape[0] != gate_w.shape[-1]:
        raise ShapeError(
            f"moe: W1 expert count {w1.shape[0]} != GateW experts "
            f"{gate_w.shape[-1]}")
    return {"Out": x, "AuxLoss": VarInfo((), "float32")}


@register_shard_fn("moe")
def _moe_shard(op, ins, attrs):
    x = first_in(ins, "X")
    if x.spec is None:
        return {}
    return {"Out": x.spec, "AuxLoss": ()}
