"""Collectives over mesh axes (counterpart of
``paddle_tpu/parallel/collective.py``; the reference's NCCLAllReduce /
Reduce / Bcast ops and the pserver gradient exchange).

Each function acts on the process group of one axis of the mesh bound
by :func:`spmd` (the sharded executor binds its mesh around a step, as
``shard_map`` binds axis names in the JAX package).  Outside
:func:`spmd`, or for an axis the bound mesh lacks, each is the identity,
as the JAX ones are outside SPMD.  A mesh bound without a
``torch.distributed`` world (one rank) has no groups: the identity too.

The differentiable ones are ``torch.autograd.Function``\\ s under one
convention for gradients: a value replicated over an axis carries a
*partial* gradient on each member (the members' gradients sum to the
true one), and a value sharded over it carries its true gradient.  So
the backward of a sum all-reduce is a sum all-reduce, the backward of
an all-gather is a reduce-scatter, and a loss replicated over the whole
mesh seeds its backward with ``1 / mesh size`` on each rank
(``parallel/sharded.py``).  Sub-fp32 floats reduce in fp32.

``calls`` counts the collectives issued by kind; it is registered with
``core.compile_cache`` (kind ``detail``), so a captured step's replays
count the collectives its capture recorded.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Sequence

import torch

from ..core import compile_cache

__all__ = ["spmd", "bound_mesh", "psum", "all_reduce", "all_gather",
           "reduce_scatter", "ppermute", "broadcast", "barrier",
           "all_to_all", "calls", "reset_counts"]

#: collectives issued, by kind (``all_reduce``, ``all_gather``, ...)
calls = compile_cache.register_launch_counter(
    collections.Counter(), name="collectives", kind="detail")

_local = threading.local()


def reset_counts():
    calls.clear()


@contextlib.contextmanager
def spmd(mesh):
    """Bind ``mesh``: collectives inside act on its axes' groups."""
    old = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = old


def bound_mesh():
    return getattr(_local, "mesh", None)


def _group(axis_name):
    """(group, size) of ``axis_name`` on the bound mesh; None outside a
    group (no mesh bound, an axis it lacks, or no world)."""
    mesh = bound_mesh()
    if mesh is None or axis_name not in mesh.shape:
        return None
    g = mesh.group(axis_name)
    if g is None:
        return None
    return g, int(mesh.shape[axis_name])


def _wide(x: torch.Tensor) -> torch.Tensor:
    """A reduction operand: sub-fp32 floats widen to fp32, and a copy
    (the collectives write in place)."""
    if x.is_floating_point() and x.element_size() < 4:
        return x.float()
    return x.clone()


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    t = _wide(x.contiguous())
    calls["all_reduce"] += 1
    torch.distributed.all_reduce(t, op=op, group=group)
    return t.to(x.dtype)


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    calls["all_gather"] += 1
    torch.distributed.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _local_slice(x: torch.Tensor, group, n: int, dim: int):
    idx = torch.distributed.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group, torch.distributed.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group, torch.distributed.ReduceOp.SUM), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        full = _reduce(g, ctx.group, torch.distributed.ReduceOp.SUM)
        return (_local_slice(full, ctx.group, ctx.n, ctx.dim).contiguous(),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        full = _reduce(x, group, torch.distributed.ReduceOp.SUM)
        return _local_slice(full, group, n, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _exchange(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return (_exchange(g, group, n, concat_axis, split_axis),
                None, None, None, None)


def _exchange(x, group, n, split_axis, concat_axis):
    ins = [c.contiguous() for c in torch.chunk(x, n, dim=split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    calls["all_to_all"] += 1
    torch.distributed.all_to_all(outs, ins, group=group)
    return torch.cat(outs, dim=concat_axis)


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------
def psum(x, axis_name="dp"):
    return all_reduce(x, axis_name, "sum")


def all_reduce(x, axis_name="dp", op="sum"):
    """``op`` in sum/mean/max/min over ``axis_name``; sum and mean are
    differentiable, max and min through an all-gather."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown all_reduce op {op}")
    got = _group(axis_name)
    if got is None:
        return x
    group, n = got
    if op in ("sum", "mean"):
        y = _AllReduceSum.apply(x, group)
        return y / n if op == "mean" else y
    stacked = _AllGather.apply(x.unsqueeze(0), group, n, 0)
    return stacked.amax(0) if op == "max" else stacked.amin(0)


def all_gather(x, axis_name="tp", axis=0, tiled=True):
    """The members' ``x`` concatenated along ``axis`` (``tiled``) or
    stacked on a new leading ``axis``."""
    got = _group(axis_name)
    if got is None:
        return x
    group, n = got
    if not tiled:
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, group, n, axis)


def reduce_scatter(x, axis_name="dp", axis=0):
    """The sum over the members, each keeping its slice of ``axis``."""
    got = _group(axis_name)
    if got is None:
        return x
    group, n = got
    return _ReduceScatter.apply(x, group, n, axis)


def ppermute(x, axis_name, perm: Sequence):
    """Member ``dst`` receives ``src``'s ``x`` for each ``(src, dst)`` of
    ``perm``; a member no pair names receives zeros."""
    got = _group(axis_name)
    if got is None:
        return x
    group, n = got
    me = torch.distributed.get_rank(group)
    src = {int(d): int(s) for s, d in perm}
    stacked = _AllGather.apply(x.unsqueeze(0), group, n, 0)
    if me not in src:
        return torch.zeros_like(x)
    return stacked[src[me]]


def broadcast(x, axis_name="dp", src=0):
    """``src``'s value on every member (the NCCLBcast analog)."""
    return ppermute(x, axis_name, [(src, i) for i in range(
        _size(axis_name))])


def _size(axis_name) -> int:
    got = _group(axis_name)
    return 1 if got is None else got[1]


def barrier(axis_name="dp"):
    """A rendezvous of the axis's members (a sum of ones: the pserver
    ``synchronize()`` analog); returns the member count."""
    mesh = bound_mesh()
    dev = None
    if mesh is not None and mesh.backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    return psum(torch.ones((), device=dev), axis_name)


def all_to_all(x, axis_name, split_axis, concat_axis):
    """Split ``x`` along ``split_axis`` into one chunk a member, send
    chunk i to member i, and concatenate what arrives along
    ``concat_axis``."""
    got = _group(axis_name)
    if got is None:
        return x
    group, n = got
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)

