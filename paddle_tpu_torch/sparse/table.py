"""Host-resident vocab-sharded embedding row store (counterpart of
``paddle_tpu/sparse/table.py``).

The reference served giant-embedding CTR models from parameter servers:
``SparseRowCpuMatrix`` held only the rows a trainer touched
(math/SparseRowMatrix.h:31-260), ``SparseRemoteParameterUpdater`` pulled
the rows a batch needs and pushed only their gradients
(RemoteParameterUpdater.h:265), and the pserver applied the sparse
optimizer update per row.  :class:`SparseTable` is that store: the table
lives in host memory (numpy shards, or mmap-backed shards for
beyond-RAM vocabs), the card only ever sees the dense
``[n_unique, dim]`` rows a batch touches, and the optimizer update for
those rows (SGD or per-row Adagrad) runs on the host in ``push``.

Rows are **lazily initialized** on first touch from the declared
initializer, so a declared vocab of 10^9 rows costs memory in
proportion to the rows a workload has seen.  Lazy draws are
deterministic per ``(seed, row_id)`` (counter-based Philox keyed by the
row id, :mod:`.philox`), so the same ids always materialize the same
rows whatever the touch order, shard count or restart, and the same rows
as the JAX package's table.

The host hot path is vectorized: a batch's missing rows draw in one
batched Philox call and the id -> arena-position map is a searchsorted
structure (:class:`_IdMap`).  The scalar originals stay as the
``impl="reference"`` oracle (per-id ``Generator(Philox(key))`` draws
and a dict index); both impls give the same rows, slots and checkpoint
bytes.

Sharding is by ``id % num_shards``.  Checkpoint export
(:meth:`export_state_vars`) is spec-agnostic: each shard serializes its
live ``(ids, rows, slots)`` triple under ``__sparse__/<table>/...``
(the JAX package's keys), and restore re-inserts rows by id under
whatever shard count the restoring table declares.

The one departure from the JAX table is the update's rounding.  Each
package's host update is its own dense optimizer op, so dense and
sparse training are bit-identical within a package on the CPU: the JAX
table emulates the FMAs that XLA contracts ``p - lr * g`` and
``m + g * g`` into, the port runs its ``sgd``/``adagrad`` ops
(``ops/optimizer_ops.py``) on the host's torch, one rounding an
operation.  The two packages' updates of a row may differ in the last
bits.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.registry import get_op_impl

from .philox import philox_uniform_rows

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["SparseTable", "PAD_ID"]

#: sentinel id for bucket-padding slots: ``pull`` returns a zero row for
#: it and ``push`` skips it (its gradient rows are structurally zero —
#: no inverse-index entry ever references a pad slot)
PAD_ID = -1

# checkpoint schema version riding in every exported meta blob
_STATE_VERSION = 1
_STATE_PREFIX = "__sparse__"

_OPTIMIZER_SLOTS = {
    # per-row slot arrays beyond the row itself, by optimizer
    "sgd": (),
    "adagrad": ("moment",),
}


def _require_int_ids(ids) -> np.ndarray:
    a = np.asarray(ids)
    if a.dtype == object:
        raise ValueError(
            "sparse table ids arrived as a ragged/mixed object array — "
            "feed a rectangular int32/int64 array (canonical dtype: "
            "int64)")
    if a.dtype.kind not in "iu":
        raise ValueError(
            f"sparse table ids must be integral (canonical dtype int64), "
            f"got {a.dtype.name}")
    return a.astype(np.int64, copy=False).reshape(-1)


class _IdMap:
    """Vectorized id -> arena-position map: a sorted base pair plus a
    small sorted tail of recent inserts (merged into the base when it
    outgrows ``max(1024, base/8)``, so cold-start insert cost stays
    amortized-constant per id instead of O(live) per batch).  Replaces
    the per-id dict lookups of the reference path with one
    ``np.searchsorted`` per level; the dict index is kept as the
    ``impl='reference'`` oracle (tests/test_sparse_vectorized.py pins
    position-for-position agreement)."""

    __slots__ = ("_bids", "_bpos", "_tids", "_tpos")

    def __init__(self):
        self._bids = np.empty(0, np.int64)
        self._bpos = np.empty(0, np.int64)
        self._tids = np.empty(0, np.int64)
        self._tpos = np.empty(0, np.int64)

    def __len__(self):
        return self._bids.size + self._tids.size

    def clear(self):
        self.__init__()

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Arena positions for ``ids`` (int64 array), -1 where absent."""
        out = np.full(ids.size, -1, np.int64)
        for lids, lpos in ((self._bids, self._bpos),
                           (self._tids, self._tpos)):
            if not lids.size:
                continue
            j = np.minimum(np.searchsorted(lids, ids), lids.size - 1)
            hit = lids[j] == ids
            if hit.any():
                out[hit] = lpos[j[hit]]
        return out

    def insert(self, ids: np.ndarray, pos: np.ndarray):
        """Add ids (disjoint from every live id) with their positions."""
        if not ids.size:
            return
        if ids.size > 1 and not np.all(ids[1:] > ids[:-1]):
            order = np.argsort(ids, kind="stable")
            ids, pos = ids[order], pos[order]
        if self._tids.size:
            j = np.searchsorted(self._tids, ids)
            self._tids = np.insert(self._tids, j, ids)
            self._tpos = np.insert(self._tpos, j, pos)
        else:
            self._tids = np.asarray(ids, np.int64).copy()
            self._tpos = np.asarray(pos, np.int64).copy()
        if self._tids.size > max(1024, self._bids.size >> 3):
            self._fold_tail()

    def _fold_tail(self):
        """Merge the sorted tail into the sorted base (arrays REBOUND,
        never mutated in place, so previously handed-out views stay
        stable)."""
        if not self._tids.size:
            return
        j = np.searchsorted(self._bids, self._tids)
        self._bids = np.insert(self._bids, j, self._tids)
        self._bpos = np.insert(self._bpos, j, self._tpos)
        self._tids = np.empty(0, np.int64)
        self._tpos = np.empty(0, np.int64)

    def sorted_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, positions) with ids ascending — the checkpoint-export
        order (folds the tail into the base first)."""
        self._fold_tail()
        return self._bids, self._bpos


class _MemoryShard:
    """One vocab shard: an id -> arena-row index plus growable arenas for
    the rows and each optimizer slot.  Not thread-safe on its own — the
    owning table serializes access.  ``index`` is an :class:`_IdMap`
    (vectorized impl) or a plain dict (the reference oracle impl)."""

    def __init__(self, dim: int, slot_names: Tuple[str, ...], dtype,
                 use_dict_index: bool = False):
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.index = {} if use_dict_index else _IdMap()
        self.n = 0
        self._cap = 0
        self.rows = np.empty((0, self.dim), self.dtype)
        self.slots: Dict[str, np.ndarray] = {
            s: np.empty((0, self.dim), self.dtype) for s in slot_names}
        # incremental-checkpoint bookkeeping, aligned with the arena
        # (positions are append-only and stable): pos_ids inverts the
        # id map (arena position -> id) so a delta export costs
        # O(dirty), and dirty marks positions touched since the last
        # ACKED commit.  Always plain in-memory arrays — even for mmap
        # arenas — because they are transient commit state.
        self.pos_ids = np.empty(0, np.int64)
        self.dirty = np.zeros(0, bool)

    # -- arena management ---------------------------------------------------
    def _alloc(self, shape) -> np.ndarray:
        return np.empty(shape, self.dtype)

    def _grow_to(self, cap: int):
        new_rows = self._alloc((cap, self.dim))
        new_rows[:self.n] = self.rows[:self.n]
        self.rows = new_rows
        for s, arr in self.slots.items():
            new = self._alloc((cap, self.dim))
            new[:self.n] = arr[:self.n]
            self.slots[s] = new
        new_ids = np.empty(cap, np.int64)
        new_ids[:self.n] = self.pos_ids[:self.n]
        self.pos_ids = new_ids
        new_dirty = np.zeros(cap, bool)
        new_dirty[:self.n] = self.dirty[:self.n]
        self.dirty = new_dirty
        self._cap = cap

    def reserve(self, extra: int):
        need = self.n + int(extra)
        if need <= self._cap:
            return
        cap = max(64, self._cap)
        while cap < need:
            cap *= 2
        self._grow_to(cap)

    def insert(self, ids: np.ndarray, rows: np.ndarray,
               slots: Optional[Dict[str, np.ndarray]] = None):
        """Append rows for ids NOT already present (caller pre-filters)."""
        k = len(ids)
        if k == 0:
            return
        self.reserve(k)
        sl = slice(self.n, self.n + k)
        self.rows[sl] = rows
        for s, arr in self.slots.items():
            if slots is not None and s in slots:
                arr[sl] = slots[s]
            else:
                arr[sl] = 0
        self.pos_ids[sl] = ids
        # lazily initialized rows are dirty: a full export includes
        # them, so a delta chain must too for bit-identical replay
        self.dirty[sl] = True
        if isinstance(self.index, dict):
            for j, i in enumerate(ids.tolist()):
                self.index[int(i)] = self.n + j
        else:
            self.index.insert(np.asarray(ids, np.int64),
                              np.arange(self.n, self.n + k,
                                        dtype=np.int64))
        self.n += k

    def clear(self):
        self.index.clear()
        self.dirty[:] = False
        self.n = 0


class _MmapShard(_MemoryShard):
    """Arena variant backed by ``np.memmap`` spool files — the
    beyond-RAM storage plug.  Growth rewrites the spool at double
    capacity (amortized, like the in-memory arena)."""

    def __init__(self, dim: int, slot_names: Tuple[str, ...], dtype,
                 spool_dir: str, shard_id: int,
                 use_dict_index: bool = False):
        self._spool_dir = spool_dir
        self._shard_id = int(shard_id)
        self._gen = 0
        os.makedirs(spool_dir, exist_ok=True)
        super().__init__(dim, slot_names, dtype,
                         use_dict_index=use_dict_index)

    def _path(self, tag: str) -> str:
        return os.path.join(self._spool_dir,
                            f"s{self._shard_id}-{tag}-g{self._gen}.mm")

    def _alloc(self, shape) -> np.ndarray:
        if shape[0] == 0:
            return np.empty(shape, self.dtype)
        tag = f"{shape[0]}x{'x'.join(str(d) for d in shape[1:])}-" \
              f"{len(os.listdir(self._spool_dir))}"
        return np.memmap(self._path(tag), dtype=self.dtype, mode="w+",
                         shape=tuple(shape))

    def _grow_to(self, cap: int):
        old = [self.rows] + [self.slots[s] for s in self.slots]
        self._gen += 1
        super()._grow_to(cap)
        # old spool files are dropped once their arrays die; best-effort
        # unlink keeps the spool dir bounded on long runs
        for arr in old:
            fname = getattr(arr, "filename", None)
            del arr
            if fname is not None:
                try:
                    os.unlink(fname)
                except OSError:
                    pass


class SparseTable:
    """Host-resident sharded embedding table with per-row optimizer
    state.

    * ``optimizer``: ``"sgd"`` (no slot state) or ``"adagrad"`` (one
      per-row accumulator, the reference's sparse-Adagrad semantics).
      The host update rounds as the port's optimizer ops do, which makes
      dense-vs-sparse training bit-identical
      (tests/test_torch_sparse_trainer.py).
    * ``initializer``: per-row lazy initializer: ``None`` (uniform
      ±``init_scale``), ``("uniform", low, high)``, ``("constant", v)``,
      ``("dense", array)`` (slice rows out of a materialized init, the
      parity path), or a callable ``f(id) -> row``.
    * ``storage``: ``"memory"`` (numpy arenas) or ``"mmap"`` (memmap
      spool files under ``storage_dir``) for beyond-RAM vocabs.
    * ``impl``: ``"vectorized"`` (batched Philox lazy init +
      searchsorted id map, the default) or ``"reference"`` (the scalar
      per-row/dict-index oracle).  Both give the same rows, slots and
      checkpoint bytes.
    """

    def __init__(self, name: str, vocab_size: int, dim: int, *,
                 dtype="float32", num_shards: int = 1,
                 optimizer: str = "sgd", learning_rate: float = 0.01,
                 epsilon: float = 1e-6,
                 initializer=None, init_scale: float = 0.05,
                 seed: int = 0,
                 storage: str = "memory",
                 storage_dir: Optional[str] = None,
                 impl: str = "vectorized"):
        if not name:
            raise ValueError("SparseTable: name must be non-empty")
        if vocab_size < 1 or dim < 1:
            raise ValueError(
                f"SparseTable {name!r}: vocab_size/dim must be >= 1, got "
                f"{vocab_size}/{dim}")
        if num_shards < 1:
            raise ValueError(
                f"SparseTable {name!r}: num_shards must be >= 1")
        if optimizer not in _OPTIMIZER_SLOTS:
            raise ValueError(
                f"SparseTable {name!r}: optimizer must be one of "
                f"{sorted(_OPTIMIZER_SLOTS)}, got {optimizer!r} (dense "
                f"optimizers keep their full-table device path)")
        self.name = str(name)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.num_shards = int(num_shards)
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        self.epsilon = float(epsilon)
        self.seed = int(seed)
        self._init = self._normalize_init(initializer, init_scale)
        self._lock = threading.RLock()
        self.slot_names = _OPTIMIZER_SLOTS[optimizer]
        if impl not in ("vectorized", "reference"):
            raise ValueError(
                f"SparseTable {name!r}: impl must be 'vectorized' or "
                f"'reference', got {impl!r}")
        self.impl = impl
        use_dict = impl == "reference"
        if storage == "memory":
            self._shards: List[_MemoryShard] = [
                _MemoryShard(self.dim, self.slot_names, self.dtype,
                             use_dict_index=use_dict)
                for _ in range(self.num_shards)]
        elif storage == "mmap":
            if not storage_dir:
                raise ValueError(
                    f"SparseTable {name!r}: storage='mmap' needs "
                    f"storage_dir")
            self._shards = [
                _MmapShard(self.dim, self.slot_names, self.dtype,
                           os.path.join(storage_dir, self.name), k,
                           use_dict_index=use_dict)
                for k in range(self.num_shards)]
        else:
            raise ValueError(
                f"SparseTable {name!r}: storage must be 'memory' or "
                f"'mmap', got {storage!r}")
        self.storage = storage
        # counters (plain ints/floats: always maintained; the session
        # mirrors them into the observability registry when observing).
        # last_init is an atomically-rebound (rows, seconds) tuple of
        # the most recent lazy-init batch — the race-free source for
        # the init-rate gauge under concurrent session workers.
        self.rows_initialized = 0
        self.init_seconds = 0.0
        self.last_init = None
        # incremental-checkpoint pending sets: an export snapshot moves
        # the dirty positions into _pending under an opaque token; a
        # durable-commit ack drops them (commit_delta), a writer failure
        # re-marks them dirty (retract_delta).  _ckpt_gen fences stale
        # tokens across a restore (restore rebinds arena contents, so a
        # pre-restore snapshot's positions no longer mean anything).
        self._pending: Dict[int, Tuple[int, List[np.ndarray]]] = {}
        self._next_token = 0
        self._ckpt_gen = 0

    # -- init ---------------------------------------------------------------
    @staticmethod
    def _normalize_init(initializer, init_scale):
        if initializer is None:
            return ("uniform", -float(init_scale), float(init_scale))
        if callable(initializer):
            return ("callable", initializer)
        if isinstance(initializer, np.ndarray):
            return ("dense", np.asarray(initializer))
        kind = initializer[0]
        if kind == "uniform":
            _, low, high = initializer
            return ("uniform", float(low), float(high))
        if kind == "constant":
            return ("constant", float(initializer[1]))
        if kind == "dense":
            return ("dense", np.asarray(initializer[1]))
        raise ValueError(
            f"SparseTable initializer {initializer!r} not understood "
            f"(uniform/constant/dense/callable)")

    def _init_rows(self, ids: np.ndarray) -> np.ndarray:
        """Deterministic per-(seed, id) lazy row values for new ids —
        one batched Philox draw over all of them (bit-identical to the
        per-id :meth:`_reference_init_rows` oracle)."""
        kind = self._init[0]
        k = len(ids)
        if kind == "constant":
            return np.full((k, self.dim), self._init[1], self.dtype)
        if kind == "dense":
            dense = self._init[1]
            if dense.shape != (self.vocab_size, self.dim):
                raise ValueError(
                    f"SparseTable {self.name!r}: dense initializer shape "
                    f"{dense.shape} != (vocab={self.vocab_size}, "
                    f"dim={self.dim})")
            return dense[ids].astype(self.dtype, copy=True)
        if kind == "callable":
            out = np.empty((k, self.dim), self.dtype)
            fn = self._init[1]
            for j, i in enumerate(ids.tolist()):
                out[j] = np.asarray(fn(int(i)), self.dtype)
            return out
        _, low, high = self._init
        return philox_uniform_rows(self.seed, ids, self.dim, low,
                                   high).astype(self.dtype)

    def _reference_init_rows(self, ids: np.ndarray) -> np.ndarray:
        """Original scalar lazy init, kept as the oracle for the
        batched-Philox bit-identity tests and the scalar arm of the
        benchmark's scalar-vs-vectorized A/B."""
        kind = self._init[0]
        k = len(ids)
        if kind in ("constant", "dense", "callable"):
            return self._init_rows(ids)       # identical in both impls
        out = np.empty((k, self.dim), self.dtype)
        _, low, high = self._init
        for j, i in enumerate(ids.tolist()):
            # counter-based generator keyed by (seed, id): touch-order-
            # and shard-count-independent determinism
            g = np.random.Generator(np.random.Philox(
                key=(self.seed << 32) ^ (int(i) & 0xFFFFFFFF)))
            out[j] = g.uniform(low, high, self.dim).astype(self.dtype)
        return out

    # -- id plumbing --------------------------------------------------------
    def _validate(self, ids: np.ndarray, what: str):
        live = ids[ids != PAD_ID]
        if live.size == 0:
            return live
        lo, hi = int(live.min()), int(live.max())
        if lo < 0:
            raise ValueError(
                f"sparse table {self.name!r}: {what} contains negative "
                f"id {lo} (valid range [0, {self.vocab_size}); "
                f"{PAD_ID} is reserved for bucket padding and only the "
                f"session may feed it)")
        if hi >= self.vocab_size:
            raise ValueError(
                f"sparse table {self.name!r}: {what} contains "
                f"out-of-vocab id {hi} (valid range "
                f"[0, {self.vocab_size}))")
        return live

    def _by_shard(self, live: np.ndarray):
        shard_of = live % self.num_shards
        for k in range(self.num_shards):
            sel = np.nonzero(shard_of == k)[0]
            if sel.size:
                yield k, sel, live[sel]

    def _ensure_rows(self, shard: _MemoryShard, sids: np.ndarray):
        """Reference-impl lazy materialization: per-shard missing scan
        against the dict index + the scalar per-id init oracle."""
        missing = np.array([i for i in sids.tolist()
                            if int(i) not in shard.index], np.int64)
        if missing.size == 0:
            return
        missing = np.unique(missing)
        t0 = time.perf_counter()
        shard.insert(missing, self._reference_init_rows(missing))
        dt = time.perf_counter() - t0
        self.init_seconds += dt
        self.rows_initialized += int(missing.size)
        self.last_init = (int(missing.size), dt)

    def _lookup_ensure(self, live: np.ndarray):
        """Vectorized per-batch resolution: ONE shard partition + ONE
        id-map lookup for the whole batch, with every missing row
        materialized by ONE batched Philox call (per-call kernel
        overhead paid once per batch, not once per shard — and the
        insert offsets patch the positions in place, so present+new
        rows gather without a second lookup).  Slicing one batched draw
        per shard is bit-identical to per-shard draws (rows are
        independent per id).  Returns ``[(shard_idx, sel, positions)]``
        with ``sel`` indexing into ``live``."""
        parts = []
        missing = []                 # (part_idx, sorted-unique miss ids)
        for k, sel, sids in self._by_shard(live):
            pos = self._shards[k].index.lookup(sids)
            parts.append((k, sel, sids, pos))
            if (pos < 0).any():
                missing.append((len(parts) - 1,
                                np.unique(sids[pos < 0])))
        if missing:
            t0 = time.perf_counter()
            rows = self._init_rows(np.concatenate(
                [m for _, m in missing]))
            off = 0
            for pi, miss in missing:
                k, _sel, sids, pos = parts[pi]
                shard = self._shards[k]
                n0 = shard.n         # miss[j] lands at arena n0 + j
                shard.insert(miss, rows[off:off + len(miss)])
                off += len(miss)
                neg = pos < 0
                pos[neg] = n0 + np.searchsorted(miss, sids[neg])
            dt = time.perf_counter() - t0
            self.init_seconds += dt
            self.rows_initialized += off
            self.last_init = (off, dt)
        return [(k, sel, pos) for k, sel, _sids, pos in parts]

    def _reference_parts(self, live: np.ndarray):
        """Reference-impl form of :meth:`_lookup_ensure`: per-shard
        scalar ensure + per-id dict gathers (the oracle's cost shape)."""
        out = []
        for k, sel, sids in self._by_shard(live):
            shard = self._shards[k]
            self._ensure_rows(shard, sids)
            out.append((k, sel, np.fromiter(
                (shard.index[int(i)] for i in sids.tolist()),
                np.int64, len(sids))))
        return out

    def _parts(self, live: np.ndarray):
        if self.impl == "reference":
            return self._reference_parts(live)
        return self._lookup_ensure(live)

    # -- pull/push ----------------------------------------------------------
    def pull(self, ids) -> np.ndarray:
        """Rows for ``ids`` (1-D int array; ``PAD_ID`` slots come back
        zero).  Missing rows lazily initialize.  Returns a fresh
        ``[len(ids), dim]`` array the caller owns."""
        ids = _require_int_ids(ids)
        out = np.zeros((len(ids), self.dim), self.dtype)
        with self._lock:
            self._validate(ids, "pull ids")
            live_sel = np.nonzero(ids != PAD_ID)[0]
            live = ids[live_sel]
            for k, sel, rows_idx in self._parts(live):
                out[live_sel[sel]] = self._shards[k].rows[rows_idx]
        return out

    def pull_slot(self, slot: str, ids) -> np.ndarray:
        """Slot-state rows (e.g. the Adagrad accumulator) for ``ids`` —
        zero for PAD/untouched rows.  Test/inspection surface."""
        ids = _require_int_ids(ids)
        out = np.zeros((len(ids), self.dim), self.dtype)
        with self._lock:
            live_sel = np.nonzero(ids != PAD_ID)[0]
            live = ids[live_sel]
            for k, sel, sids in self._by_shard(live):
                shard = self._shards[k]
                arr = shard.slots[slot]
                if self.impl == "reference":
                    for j, i in zip(sel.tolist(), sids.tolist()):
                        pos = shard.index.get(int(i))
                        if pos is not None:
                            out[live_sel[j]] = arr[pos]
                else:
                    pos = shard.index.lookup(sids)
                    have = pos >= 0
                    if have.any():
                        out[live_sel[sel[have]]] = arr[pos[have]]
        return out

    def push(self, ids, grad_rows, *, learning_rate: Optional[float] = None
             ) -> int:
        """Apply the sparse optimizer update for ``ids`` with their
        gradient rows; ``PAD_ID`` slots are skipped.  ``ids`` must be
        unique among live entries (the session's dedup guarantees it).
        Returns the number of rows updated.

        The update is the port's own ``sgd``/``adagrad`` op
        (``ops/optimizer_ops.py``) run on the host's torch, so a push
        gives those rows what the dense path's update gives them on the
        CPU, bit for bit.  (On a card the dense update runs CUDA's
        kernels, whose ``sqrt`` rounds correctly where the CPU's may
        not.)
        """
        ids = _require_int_ids(ids)
        grads = np.asarray(grad_rows, self.dtype)
        if grads.shape != (len(ids), self.dim):
            raise ValueError(
                f"sparse table {self.name!r}: push grads shape "
                f"{grads.shape} != ({len(ids)}, {self.dim})")
        lr = torch.from_numpy(np.asarray(
            [self.learning_rate if learning_rate is None
             else learning_rate], self.dtype))
        updated = 0
        with self._lock:
            live_all = self._validate(ids, "push ids")
            if len(np.unique(live_all)) != len(live_all):
                raise ValueError(
                    f"sparse table {self.name!r}: push ids contain "
                    f"duplicates — dedup (np.unique) before pushing, or "
                    f"duplicate rows would double-apply")
            live_sel = np.nonzero(ids != PAD_ID)[0]
            live = ids[live_sel]
            parts = list(self._parts(live))
            if not parts:
                return 0
            # one op over every shard's rows (the update is elementwise)
            slot = "moment" if self.optimizer == "adagrad" else None

            def gathered(get):
                return torch.from_numpy(np.concatenate(
                    [get(self._shards[k])[idx] for k, _, idx in parts]))
            ins = {"Param": [gathered(lambda sh: sh.rows)],
                   "Grad": [torch.from_numpy(grads[np.concatenate(
                       [live_sel[sel] for _, sel, _ in parts])])],
                   "LearningRate": [lr]}
            if slot is None:
                out = get_op_impl("sgd")(None, ins, {})
            else:
                ins["Moment"] = [gathered(lambda sh: sh.slots[slot])]
                out = get_op_impl("adagrad")(
                    None, ins, {"epsilon": self.epsilon})
                new_slot = out["MomentOut"].numpy()
            new_rows = out["ParamOut"].numpy()
            off = 0
            for k, _, idx in parts:
                shard = self._shards[k]
                shard.dirty[idx] = True
                span = slice(off, off + len(idx))
                shard.rows[idx] = new_rows[span]
                if slot is not None:
                    shard.slots[slot][idx] = new_slot[span]
                off += len(idx)
            updated = off
        return updated

    # -- inspection ---------------------------------------------------------
    @property
    def live_rows(self) -> int:
        with self._lock:
            return sum(s.n for s in self._shards)

    def dense_bytes(self) -> int:
        """Bytes the full dense table would occupy on one device (the
        comparison the CTR benchmark reports)."""
        return self.vocab_size * self.dim * self.dtype.itemsize

    def host_bytes(self) -> int:
        with self._lock:
            per_row = self.dim * self.dtype.itemsize * \
                (1 + len(self.slot_names))
            return sum(s.n for s in self._shards) * per_row

    # -- checkpoint (Checkpointer-rider form) -------------------------------
    def _meta(self) -> dict:
        return {"version": _STATE_VERSION, "name": self.name,
                "vocab_size": self.vocab_size, "dim": self.dim,
                "dtype": self.dtype.name, "optimizer": self.optimizer,
                "learning_rate": self.learning_rate,
                "epsilon": self.epsilon, "seed": self.seed,
                "num_shards_at_save": self.num_shards,
                "slots": list(self.slot_names)}

    def export_state_vars(self) -> Dict[str, np.ndarray]:
        """Serialize the live rows as synthetic scope vars — the form the
        trainer's :class:`~paddle_tpu_torch.train_state.Checkpointer` commits
        atomically alongside the model (same md5/tmp+rename/fallback
        machinery as every other checkpointed var).  Ids are sorted per
        shard so the export is byte-deterministic.  All arrays are fresh
        copies: the async checkpoint writer may still be serializing them
        while training mutates the arenas."""
        with self._lock:
            return self._export_state_vars_locked()

    def _export_state_vars_locked(self) -> Dict[str, np.ndarray]:
        prefix = f"{_STATE_PREFIX}/{self.name}"
        out: Dict[str, np.ndarray] = {}
        out[f"{prefix}/meta"] = np.frombuffer(
            json.dumps(self._meta(), sort_keys=True).encode("utf-8"),
            dtype=np.uint8).copy()
        for k, shard in enumerate(self._shards):
            if self.impl == "reference":
                ids = np.array(sorted(shard.index), np.int64)
                pos = np.fromiter((shard.index[int(i)] for i in ids),
                                  np.int64, len(ids))
            else:
                ids, pos = shard.index.sorted_items()
                # same aliasing guarantee as the reference branch:
                # the exported array must never be a live view of
                # the id map (a consumer mutating it would corrupt
                # the index)
                ids = ids.copy()
            out[f"{prefix}/shard{k}/ids"] = ids
            out[f"{prefix}/shard{k}/rows"] = \
                shard.rows[pos].copy() if len(ids) else \
                np.empty((0, self.dim), self.dtype)
            for s in self.slot_names:
                out[f"{prefix}/shard{k}/slot/{s}"] = \
                    shard.slots[s][pos].copy() if len(ids) else \
                    np.empty((0, self.dim), self.dtype)
        return out

    # -- incremental checkpoint (dirty-row deltas) --------------------------
    @property
    def dirty_rows(self) -> int:
        """Rows touched (pushed or lazily initialized) since the last
        ACKED commit snapshot — the size the next delta would export."""
        with self._lock:
            return sum(int(s.dirty[:s.n].sum()) for s in self._shards)

    def _snapshot_dirty_locked(self) -> Tuple[int, List[np.ndarray]]:
        """Move every currently-dirty position into a pending set keyed
        by a fresh token.  Caller holds the lock.  The snapshot happens
        BEFORE any serialization is handed to an async writer, so a row
        pushed DURING serialization re-enters the dirty set (its
        position is simply marked again) and is never silently clean."""
        pend = []
        for shard in self._shards:
            pos = np.nonzero(shard.dirty[:shard.n])[0]
            shard.dirty[pos] = False
            pend.append(pos)
        token = self._next_token
        self._next_token += 1
        self._pending[token] = (self._ckpt_gen, pend)
        return token, pend

    def export_delta(self) -> Tuple[int, Dict[str, np.ndarray]]:
        """Serialize ONLY the rows touched since the last acked commit,
        as ``(token, state)``: the same synthetic-scope-var keys as
        :meth:`export_state_vars` (meta + per-shard sorted
        ``ids``/``rows``/``slot/*``) but each shard carries just its
        dirty rows.  The dirty positions move to a pending set under
        ``token`` — call :meth:`commit_delta` after the durable ack, or
        :meth:`retract_delta` on writer failure (which re-marks them
        dirty so the rows ride the next commit).  All arrays are fresh
        copies."""
        prefix = f"{_STATE_PREFIX}/{self.name}"
        out: Dict[str, np.ndarray] = {}
        with self._lock:
            token, pend = self._snapshot_dirty_locked()
            out[f"{prefix}/meta"] = np.frombuffer(
                json.dumps(self._meta(), sort_keys=True).encode("utf-8"),
                dtype=np.uint8).copy()
            for k, shard in enumerate(self._shards):
                pos = pend[k]
                if pos.size:
                    ids = shard.pos_ids[pos]
                    order = np.argsort(ids, kind="stable")
                    ids, pos = ids[order], pos[order]
                    out[f"{prefix}/shard{k}/ids"] = ids.copy()
                    out[f"{prefix}/shard{k}/rows"] = shard.rows[pos].copy()
                    for s in self.slot_names:
                        out[f"{prefix}/shard{k}/slot/{s}"] = \
                            shard.slots[s][pos].copy()
                else:
                    out[f"{prefix}/shard{k}/ids"] = np.empty(0, np.int64)
                    out[f"{prefix}/shard{k}/rows"] = \
                        np.empty((0, self.dim), self.dtype)
                    for s in self.slot_names:
                        out[f"{prefix}/shard{k}/slot/{s}"] = \
                            np.empty((0, self.dim), self.dtype)
        return token, out

    def export_full(self) -> Tuple[int, Dict[str, np.ndarray]]:
        """Full export under the same token protocol — the periodic
        rebase form: snapshots (clears) the dirty set atomically with
        the serialization, so an acked full commit leaves exactly the
        rows pushed after it dirty."""
        with self._lock:
            token, _pend = self._snapshot_dirty_locked()
            out = self._export_state_vars_locked()
        return token, out

    def commit_delta(self, token: int):
        """Durable-ack: forget the pending positions of ``token`` (they
        are in a committed checkpoint now).  Idempotent; tolerates
        tokens invalidated by a restore."""
        with self._lock:
            self._pending.pop(token, None)

    def retract_delta(self, token: int):
        """Writer-failure path: re-mark the pending positions of
        ``token`` dirty so those rows ride the next commit.  Idempotent;
        a token minted before a restore is a stale no-op (the restore
        already rebuilt table contents from a durable checkpoint)."""
        with self._lock:
            entry = self._pending.pop(token, None)
            if entry is None or entry[0] != self._ckpt_gen:
                return
            for shard, pos in zip(self._shards, entry[1]):
                shard.dirty[pos] = True

    def restore_state_vars(self, state: Dict[str, np.ndarray]):
        """Restore from an :meth:`export_state_vars` mapping (keys may
        carry any shard count — rows re-insert by id under THIS table's
        ``num_shards``)."""
        prefix = f"{_STATE_PREFIX}/{self.name}"
        meta_key = f"{prefix}/meta"
        if meta_key not in state:
            raise ValueError(
                f"sparse table {self.name!r}: checkpoint carries no "
                f"state for this table (keys: "
                f"{sorted(k for k in state if k.startswith(_STATE_PREFIX))}"
                f") — was it written by a run without this table?")
        meta = json.loads(bytes(np.asarray(state[meta_key],
                                           np.uint8)).decode("utf-8"))
        if int(meta.get("version", 0)) > _STATE_VERSION:
            raise ValueError(
                f"sparse table {self.name!r}: checkpoint state version "
                f"{meta['version']} is newer than this runtime "
                f"({_STATE_VERSION})")
        for field in ("dim", "optimizer"):
            if meta.get(field) != getattr(self, field):
                raise ValueError(
                    f"sparse table {self.name!r}: checkpoint {field} "
                    f"{meta.get(field)!r} != declared "
                    f"{getattr(self, field)!r}")
        if meta.get("vocab_size") != self.vocab_size:
            logger.warning(
                "sparse table %r: checkpoint vocab %s != declared %s "
                "(restoring anyway; ids must stay in the smaller range)",
                self.name, meta.get("vocab_size"), self.vocab_size)
        saved_shards = int(meta.get("num_shards_at_save", 1))
        with self._lock:
            for shard in self._shards:
                shard.clear()
            for k in range(saved_shards):
                ids_key = f"{prefix}/shard{k}/ids"
                if ids_key not in state:
                    raise ValueError(
                        f"sparse table {self.name!r}: checkpoint missing "
                        f"{ids_key} (meta says {saved_shards} shards)")
                ids = np.asarray(state[ids_key], np.int64)
                rows = np.asarray(state[f"{prefix}/shard{k}/rows"],
                                  self.dtype).reshape(len(ids), self.dim)
                slots = {s: np.asarray(
                    state[f"{prefix}/shard{k}/slot/{s}"],
                    self.dtype).reshape(len(ids), self.dim)
                    for s in self.slot_names}
                self._insert_by_id(ids, rows, slots)
            # a restored table IS the committed checkpoint state: every
            # row is clean relative to it, and any pre-restore snapshot
            # token is stale (positions were rebuilt)
            for shard in self._shards:
                shard.dirty[:shard.n] = False
            self._pending.clear()
            self._ckpt_gen += 1

    def _insert_by_id(self, ids: np.ndarray, rows: np.ndarray,
                      slots: Dict[str, np.ndarray]):
        for k, sel, sids in self._by_shard(ids):
            self._shards[k].insert(
                sids, rows[sel],
                {s: arr[sel] for s, arr in slots.items()})

    # -- standalone save/load (serving, benchmarks) -------------------------
    def save(self, dirname: str):
        """Standalone directory form (npz per shard + meta.json) for
        serving deploys and benchmarks; the training-time path is
        :meth:`export_state_vars` through the Checkpointer."""
        os.makedirs(dirname, exist_ok=True)
        state = self.export_state_vars()
        prefix = f"{_STATE_PREFIX}/{self.name}"
        with open(os.path.join(dirname, "meta.json"), "w") as fh:
            json.dump(self._meta(), fh, sort_keys=True, indent=1)
        for k in range(self.num_shards):
            np.savez(
                os.path.join(dirname, f"shard{k}.npz"),
                ids=state[f"{prefix}/shard{k}/ids"],
                rows=state[f"{prefix}/shard{k}/rows"],
                **{f"slot_{s}": state[f"{prefix}/shard{k}/slot/{s}"]
                   for s in self.slot_names})

    @classmethod
    def load(cls, dirname: str, *, num_shards: Optional[int] = None,
             storage: str = "memory",
             storage_dir: Optional[str] = None,
             impl: str = "vectorized") -> "SparseTable":
        with open(os.path.join(dirname, "meta.json")) as fh:
            meta = json.load(fh)
        table = cls(meta["name"], meta["vocab_size"], meta["dim"],
                    dtype=meta["dtype"], optimizer=meta["optimizer"],
                    learning_rate=meta["learning_rate"],
                    epsilon=meta["epsilon"], seed=meta["seed"],
                    num_shards=num_shards or meta["num_shards_at_save"],
                    storage=storage, storage_dir=storage_dir, impl=impl)
        prefix = f"{_STATE_PREFIX}/{meta['name']}"
        state: Dict[str, np.ndarray] = {
            f"{prefix}/meta": np.frombuffer(
                json.dumps(meta, sort_keys=True).encode("utf-8"),
                dtype=np.uint8).copy()}
        # meta written by save() equals _meta() content-wise; rebuild the
        # state mapping from the shard files and reuse the rider path
        for k in range(int(meta["num_shards_at_save"])):
            z = np.load(os.path.join(dirname, f"shard{k}.npz"))
            state[f"{prefix}/shard{k}/ids"] = z["ids"]
            state[f"{prefix}/shard{k}/rows"] = z["rows"]
            for s in meta["slots"]:
                state[f"{prefix}/shard{k}/slot/{s}"] = z[f"slot_{s}"]
        table.restore_state_vars(state)
        return table

    def __repr__(self):
        return (f"SparseTable({self.name!r}, vocab={self.vocab_size}, "
                f"dim={self.dim}, opt={self.optimizer}, "
                f"shards={self.num_shards}, live={self.live_rows})")
