"""The mesh of ranks (counterpart of ``paddle_tpu/parallel/mesh.py``).

The JAX package names a ``jax.sharding.Mesh`` of devices driven by one
process.  Here every rank is a process (``distributed.launch``), and a
:class:`Mesh` lays the ranks of the ``torch.distributed`` world out on
named axes, the parallelism taxonomy of the JAX package:

    dp — data parallel (batch)          tp — tensor parallel (hidden)
    pp — pipeline stages                sp — sequence/context parallel
    ep — expert parallel

Rank ``r`` sits at ``np.unravel_index(r, shape)`` (row-major, tp
innermost), so the inner axes group adjacent ranks (the cards of one
node) and the outer ones span nodes.  Each axis maps to the process
groups of the ranks that differ only along it; :meth:`Mesh.group` gives
this rank's.  The groups are made together, on every rank, the first
time any is asked for (``torch.distributed.new_group`` is collective).
Without a ``torch.distributed`` world there are no groups, and a
one-rank mesh's collectives are the identity.

``PartitionSpec`` (``P``) is a tuple of per-dim entries (an axis name,
a tuple of names, or None), as ``jax.sharding.PartitionSpec``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["MeshConfig", "Mesh", "PartitionSpec", "P", "NamedSharding",
           "make_mesh", "make_hybrid_mesh", "mesh_for_axes", "get_mesh",
           "mesh_guard", "named_sharding", "world_size", "world_rank"]


class PartitionSpec(tuple):
    """Per-dim sharding entries: an axis name, a tuple of axis names, or
    None (replicated); ``P("tp", None)`` shards dim 0 over ``tp``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + super().__repr__()


P = PartitionSpec


@dataclasses.dataclass
class MeshConfig:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def size(self):
        return self.dp * self.tp * self.pp * self.sp * self.ep

    def axis_sizes(self) -> Tuple[Tuple[str, int], ...]:
        return (("dp", self.dp), ("pp", self.pp), ("sp", self.sp),
                ("ep", self.ep), ("tp", self.tp))


def world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def world_rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class Mesh:
    """Ranks on named axes: ``devices`` (the rank array), ``axis_names``,
    ``shape`` (axis -> size, ordered).  A context manager, as the JAX
    mesh is: ``with mesh:`` makes it the ambient mesh (:func:`get_mesh`).
    """

    def __init__(self, ranks, axis_names: Sequence[str]):
        arr = np.asarray(ranks, dtype=np.int64)
        names = tuple(str(a) for a in axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"mesh: {arr.ndim} dims for axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh: repeated axis name in {names}")
        self.devices = arr
        self.axis_names = names
        self.shape = collections.OrderedDict(zip(names, arr.shape))
        self.size = int(arr.size)
        self._groups: Optional[Dict[str, object]] = None
        self._guard = []

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes})"

    # -- where this rank sits -------------------------------------------------
    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` (default this process's)."""
        rank = world_rank() if rank is None else int(rank)
        hit = np.argwhere(self.devices == rank)
        if len(hit) == 0:
            raise ValueError(f"rank {rank} is not in {self!r} (ranks "
                             f"{self.devices.ravel().tolist()})")
        return dict(zip(self.axis_names, (int(i) for i in hit[0])))

    def axis_ranks(self, axis: str, rank: Optional[int] = None
                   ) -> Tuple[int, ...]:
        """The ranks of ``rank``'s group along ``axis``, in axis order."""
        c = self.coords(rank)
        idx = tuple(slice(None) if a == axis else c[a]
                    for a in self.axis_names)
        return tuple(int(r) for r in self.devices[idx].ravel())

    def extent(self, axes) -> int:
        """The product of the sizes of ``axes`` (names on this mesh)."""
        n = 1
        for a in axes:
            n *= int(self.shape.get(a, 1))
        return n

    # -- process groups -------------------------------------------------------
    def _make_groups(self):
        """Every axis's groups, made in one order on every rank (the
        groups of an axis that spans the whole world are the world's)."""
        dist = torch.distributed
        world = world_size()
        if self.size != world:
            raise RuntimeError(
                f"{self!r} spans {self.size} ranks but the world has "
                f"{world}: a mesh's groups need the whole world")
        groups = {}
        everyone = tuple(range(world))
        for ax in self.axis_names:
            mine = self.axis_ranks(ax)
            moved = np.moveaxis(self.devices, self.axis_names.index(ax), -1)
            for ranks in moved.reshape(-1, moved.shape[-1]):
                ranks = tuple(int(r) for r in ranks)
                if ranks == everyone:
                    g = dist.group.WORLD
                else:
                    g = dist.new_group(list(ranks))
                if ranks == mine:
                    groups[ax] = g
        self._groups = groups

    def group(self, axis: str):
        """This rank's process group along ``axis``; None without a
        ``torch.distributed`` world (then the mesh must be one rank)."""
        if axis not in self.shape:
            raise KeyError(f"{axis!r} is not an axis of {self!r}")
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            if self.size != 1:
                raise RuntimeError(
                    f"{self!r} spans {self.size} ranks but no "
                    f"torch.distributed world is initialized; start the "
                    f"ranks through distributed.launch.init_distributed")
            return None
        if self._groups is None:
            self._make_groups()
        return self._groups[axis]

    def backend(self) -> Optional[str]:
        """The world's collective backend (``nccl``/``gloo``), or None."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return str(dist.get_backend())
        return None

    # -- the ambient mesh -----------------------------------------------------
    def __enter__(self):
        self._guard.append(_set_current(self))
        return self

    def __exit__(self, *exc):
        _set_current(self._guard.pop())
        return False


_local = threading.local()


def _set_current(mesh):
    old = getattr(_local, "mesh", None)
    _local.mesh = mesh
    return old


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (``jax.sharding.NamedSharding``'s fields)."""
    mesh: Mesh
    spec: PartitionSpec


def _ranks(devices) -> list:
    if devices is not None:
        return [int(d) for d in devices]
    return list(range(world_size()))


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None,
              axis_names: Optional[Sequence[str]] = None,
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh from a :class:`MeshConfig` (axes dp/pp/sp/ep/tp, tp
    innermost) over ``devices`` (ranks; default the whole world), or raw
    ``(shape, axis_names)``."""
    ranks = _ranks(devices)
    if config is not None:
        names = [n for n, _ in config.axis_sizes()]
        sizes = [s for _, s in config.axis_sizes()]
        total = int(np.prod(sizes))
        if total != len(ranks):
            raise ValueError(f"mesh size {total} != rank count "
                             f"{len(ranks)}")
        return Mesh(np.asarray(ranks).reshape(sizes), names)
    return Mesh(np.asarray(ranks).reshape(tuple(shape)), axis_names)


def make_hybrid_mesh(ici_config: MeshConfig, dcn_dp: int = 1,
                     dcn_pp: int = 1,
                     per_node: Optional[int] = None) -> Mesh:
    """A mesh across nodes: each axis of ``ici_config`` (within a node of
    ``per_node`` ranks, default the ICI mesh's size) times the DCN
    factors ``dcn_dp``/``dcn_pp`` across nodes, the node factor outer,
    so only dp/pp traffic crosses nodes.  Axis names are the ICI
    config's, as in the JAX package."""
    names = [n for n, _ in ici_config.axis_sizes()]
    ici = [s for _, s in ici_config.axis_sizes()]
    dcn = [dcn_dp, dcn_pp] + [1] * (len(ici) - 2)
    per_node = int(np.prod(ici)) if per_node is None else int(per_node)
    if per_node != int(np.prod(ici)):
        raise ValueError(f"make_hybrid_mesh: the in-node mesh "
                         f"{dict(zip(names, ici))} must cover the node's "
                         f"{per_node} ranks")
    local = np.arange(per_node).reshape(ici)
    nodes = np.arange(int(np.prod(dcn))).reshape(dcn)
    full = nodes.reshape(dcn + [1] * len(ici)) * per_node + \
        local.reshape([1] * len(dcn) + ici)
    k = len(ici)
    order = [x for i in range(k) for x in (i, k + i)]
    arr = full.transpose(order).reshape([d * i for d, i in zip(dcn, ici)])
    world = world_size()
    if arr.size != world:
        raise ValueError(f"make_hybrid_mesh: {arr.size} ranks in the mesh, "
                         f"{world} in the world")
    return Mesh(arr, names)


def mesh_for_axes(axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from an ``{axis: size}`` dict over the first
    ``prod(sizes)`` ranks, with a readable error when the world has too
    few: the shared entry of ``train(auto_shard="dp=2")``."""
    axes = {str(k): int(v) for k, v in dict(axes).items()}
    n = int(np.prod(list(axes.values()))) if axes else 1
    ranks = _ranks(devices)
    if len(ranks) < n:
        raise RuntimeError(
            f"mesh {axes} needs {n} ranks, have {len(ranks)} (start {n} "
            f"processes and join them with "
            f"paddle_tpu_torch.distributed.init_distributed)")
    if not axes:
        return make_mesh(shape=[1], axis_names=["dp"], devices=ranks[:1])
    return make_mesh(shape=list(axes.values()), axis_names=list(axes),
                     devices=ranks[:n])


def get_mesh() -> Mesh:
    """The ambient mesh (set with :func:`mesh_guard` or ``with mesh:``),
    defaulting to a 1-D ``dp`` mesh over every rank of the world."""
    mesh = getattr(_local, "mesh", None)
    if mesh is not None:
        return mesh
    return Mesh(np.arange(world_size()), ("dp",))


@contextlib.contextmanager
def mesh_guard(mesh: Mesh):
    old = _set_current(mesh)
    try:
        yield mesh
    finally:
        _set_current(old)


def named_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
