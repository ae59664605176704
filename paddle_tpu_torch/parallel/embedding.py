"""Vocab-sharded embedding tables (counterpart of
``paddle_tpu/parallel/embedding.py``; the reference's row-sparse tables
and the SparseRemoteParameterUpdater that fetched only the rows a batch
touches).

A table ``[V, D]`` sharded by vocab rows over a mesh axis holds
``[V / n, D]`` on each member.  :func:`sharded_lookup` resolves the ids
that fall in this member's window, zeros the others, and sums the rows
over the axis: one all-reduce instead of a pserver round trip.  Its
gradient (through ``collective.psum``) lands on this member's rows only;
:func:`sharded_lookup_grad_rows` is that scatter-add written out, for
hand-rolled loops.  The sharded executor takes this route for a
``lookup_table`` whose ``W`` is sharded on dim 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collective

__all__ = ["sharded_lookup", "sharded_lookup_grad_rows"]


def _axes(axis_name):
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def _offset(axis_name, vshard: int) -> int:
    """Where this member's window starts: its index along the axes (the
    first one major) times the shard's row count."""
    mesh = collective.bound_mesh()
    if mesh is None:
        return 0
    coords = mesh.coords()
    idx = 0
    for a in _axes(axis_name):
        if a in mesh.shape:
            idx = idx * int(mesh.shape[a]) + coords[a]
    return idx * vshard


def _window(ids: torch.Tensor, vshard: int, offset: int):
    ids = ids.long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    local = ids - offset
    hit = (local >= 0) & (local < vshard)
    return ids, torch.where(hit, local, torch.zeros_like(local)), hit


def sharded_lookup(local_table: torch.Tensor, ids: torch.Tensor,
                   axis_name="tp", padding_idx: Optional[int] = None,
                   offset: Optional[int] = None) -> torch.Tensor:
    """Rows of a vocab-sharded table for global ``ids`` (``[...]`` or
    ``[..., 1]``): ``[..., D]``, replicated over ``axis_name`` (a name or
    a tuple of names) after one sum.  Rows of ``padding_idx`` (>= 0) are
    zeros.  ``offset`` overrides this member's first global row."""
    vshard = local_table.shape[0]
    if offset is None:
        offset = _offset(axis_name, vshard)
    ids, safe, hit = _window(ids, vshard, offset)
    if padding_idx is not None and padding_idx >= 0:
        hit = hit & (ids != padding_idx)
    rows = local_table[safe]
    rows = rows * hit.unsqueeze(-1).to(rows.dtype)
    for a in _axes(axis_name):
        rows = collective.psum(rows, a)
    return rows


def sharded_lookup_grad_rows(ids: torch.Tensor, grad_out: torch.Tensor,
                             vocab_size: int, axis_name="tp",
                             offset: Optional[int] = None) -> torch.Tensor:
    """This member's ``[V / n, D]`` gradient rows: ``grad_out``'s rows
    scatter-added at the ids in its window."""
    mesh = collective.bound_mesh()
    n = 1
    if mesh is not None:
        n = mesh.extent([a for a in _axes(axis_name) if a in mesh.shape])
    vshard = vocab_size // n
    if offset is None:
        offset = _offset(axis_name, vshard)
    _, safe, hit = _window(ids, vshard, offset)
    g = grad_out.reshape(-1, grad_out.shape[-1]) * \
        hit.reshape(-1, 1).to(grad_out.dtype)
    shard = torch.zeros((vshard, grad_out.shape[-1]), dtype=grad_out.dtype,
                        device=grad_out.device)
    return shard.index_add_(0, safe.reshape(-1), g)
