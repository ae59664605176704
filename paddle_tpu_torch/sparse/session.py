"""SparseSession: the executor rim of the host-resident parameter server
(counterpart of ``paddle_tpu/sparse/session.py``).

The reference's ``SparseRemoteParameterUpdater`` sat between the trainer
loop and the pservers: before each batch it prefetched the rows the
batch touches, after the backward it pushed only those rows' gradients
(RemoteParameterUpdater.h:265).  :class:`SparseSession` is that rim for
the port's executor, whose step is one CUDA graph on the card:

* **before the step**: per-batch id dedup (``np.unique`` + inverse
  index, padded up to a power-of-two bucket so the captured step's key
  stays stable), a cache-first pull from each bound
  :class:`~paddle_tpu_torch.sparse.table.SparseTable`, and the dense
  ``[bucket, dim]`` rows + inverse-index feeds the
  ``lookup_table_sparse`` op gathers from;
* **after the step**: the fetched ``<rows>@GRAD`` arrays go back to the
  host and a ``push`` applies the sparse optimizer update there (inside
  a retry rim with the ``sparse.push`` fault-injection site: a dropped
  push is retried or fatal, never silent);
* a bounded **hot-rows cache** (LRU, invalidated on push) with hit/miss
  accounting; the serving path pulls cache-first at request time;
* a read-only **inference mode** (``is_test=True``): pulls only, no
  grad fetches, no pushes.

Ordering: :meth:`prepare_feed` enqueues each training batch's unique-id
set FIFO; :meth:`complete` pops it.  The per-batch trainer path is
synchronous (pull -> step -> push), which is what makes small-vocab
sparse-vs-dense training bit-identical.  The chunked and pipelined
paths pull up to ``steps_per_dispatch x prefetch_depth`` batches ahead
of the pushes: bounded-staleness asynchronous updates, the reference's
async pserver SGD semantics (exact when a chunk's batches touch
disjoint ids).  With both overlap legs below on, a pull runs at most
``prefetch_depth`` batches ahead of the batch the consumer holds, and
at most ``async_push + push_flush_batch`` of the pushes before that
batch are still queued or in flight: a pull sees every push at least
``prefetch_depth + async_push + push_flush_batch + 1`` batches older
than itself (6 at depth 2, async 2 and one push a flush), so batches
that far apart may share ids and the run is still exact.

Two opt-in overlap legs extend the rim:

* **pull-ahead prefetch** (``prefetch_depth > 0``): a worker thread
  runs :meth:`prepare_feed` up to ``depth`` batches ahead of the
  consumer (it takes a free slot before it pulls, and the consumer
  frees one as it takes a batch), so batch N+1's row pulls overlap
  batch N's step (:meth:`prefetch_feeds`);
* **bounded async push** (``async_push > 0``): :meth:`complete`
  enqueues the batch's gradient push onto a worker (queue bounded at
  ``async_push`` batches, drained ``push_flush_batch`` at a time) and
  :meth:`flush` is the barrier, called before every checkpoint export
  and every read-only :meth:`prepare_feed`, so a committed checkpoint
  holds every acknowledged push and a read never misses one.  A failed
  async push re-raises at the next ``complete``/``flush``/export.

Observability: ``observe=`` (default: the ``observe`` flag, resolved
once at construction) mirrors the lifetime ``stats`` into the
``sparse/*`` counters and histograms and wraps each batch's pulls and
pushes in ``sparse/pull`` / ``sparse/push`` spans (a prefetch run's
pulls parent to its ``sparse/prefetch`` root); the session's locks come
from the lock watch.

Autotuning: omitted ``cache_rows``, ``prefetch_depth`` and
``push_flush_batch`` take the declared defaults (0 / 0 / 1), or, under
the ``autotune`` flag, the persisted ``sparse/hot_rows``,
``sparse/prefetch`` and ``sparse/push_flush`` winners.
"""
from __future__ import annotations

import collections
import queue as _queue_mod
import threading
import time
import weakref
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import faults as _faults
from .. import observability as obs
from ..core.registry import register_tunable, resolve_tuned
from ..observability.tracing import span, start_span
from ..testing import lockwatch as _lw
from ..testing import faultinject as _fi
from .table import PAD_ID, SparseTable

__all__ = ["SparseBinding", "SparseSession", "HotRowCache",
           "table_specs", "tables_for_program"]

SPARSE_OP = "lookup_table_sparse"
ROWS_SUFFIX = "@ROWS"
RIDX_SUFFIX = "@RIDX"

#: thread-name prefix of the session's workers (prefetch, async push);
#: the tests' leak fixture enforces they die with their owner
THREAD_NAME_PREFIX = "pt-sparse"

# how long an idle async-push worker lingers for more work before
# exiting (it restarts on the next enqueue; bounded linger keeps
# sessions leak-free without an explicit close())
_PUSH_LINGER_S = 0.5

# Autotuner knobs (paddle_tpu_torch.tuning), beside the host hot path they
# control, with the JAX package's spaces, defaults and decision rules.
register_tunable(
    "sparse/hot_rows", side="host",
    space={"cache_rows": (0, 1024, 16384, 65536, 262144)},
    default={"cache_rows": 0},
    description="hot-rows LRU capacity of the sparse session's cache-"
                "first pull path (0 = off; rows).  Decision rule: "
                "enable non-zero capacity when the paired A/B on the "
                "serving-style pull loop clears the 1.10x gate — the "
                "hit rate must pay for the per-row cache bookkeeping.")
register_tunable(
    "sparse/prefetch", side="host",
    space={"depth": (0, 1, 2, 4)},
    default={"depth": 0},
    description="pull-ahead prefetch depth: batches prepared ahead of "
                "the dispatch loop on the session's worker thread (0 = "
                "fully synchronous rim, the bit-parity default).  "
                "Decision rule: enable when the paired A/B on the "
                "training loop clears the 1.10x gate AND the workload "
                "tolerates pulls running up to depth+1 batches ahead "
                "of pushes (bounded-staleness async updates).")
register_tunable(
    "sparse/push_flush", side="host",
    space={"batch": (1, 2, 4, 8)},
    default={"batch": 1},
    description="async-push worker drain size: queued gradient pushes "
                "applied per worker wakeup (only reached with "
                "async_push > 0; order always FIFO, semantics "
                "unchanged).  Decision rule: raise above 1 when the "
                "paired A/B on the async-push loop clears 1.10x — the "
                "win is amortized wakeup/lock traffic, so it only "
                "moves on push-bound workloads.")


def _tuned_knob(name: str, default: Dict[str, object], key: str):
    """One omitted session knob: its declared default, or the persisted
    winner under the ``autotune`` flag."""
    return resolve_tuned(name, default)[key]


def table_specs(program) -> List[dict]:
    """Declared sparse-table specs of a program: one dict per
    ``lookup_table_sparse`` site — ``{name, vocab_size, dim, dtype}`` —
    the discovery surface benchmarks and services build tables from."""
    specs, seen = [], set()
    for b in program.blocks:
        for op in b.ops:
            if op.type != SPARSE_OP:
                continue
            name = op.attrs["table_name"]
            if name in seen:
                continue
            seen.add(name)
            specs.append({"name": name,
                          "vocab_size": int(op.attrs["vocab_size"]),
                          "dim": int(op.attrs["dim"]),
                          "dtype": op.attrs.get("dtype", "float32")})
    return specs


def tables_for_program(program, **table_kwargs) -> Dict[str, SparseTable]:
    """Build one :class:`SparseTable` per declared spec (shared
    ``table_kwargs``: optimizer, learning_rate, num_shards, ...)."""
    return {s["name"]: SparseTable(
        s["name"], s["vocab_size"], s["dim"], dtype=s["dtype"],
        **table_kwargs) for s in table_specs(program)}


class HotRowCache:
    """Bounded LRU of (table, id) -> row, with hit/miss accounting.
    Rows are stored as private copies; a push invalidates its ids so a
    cached read can never serve a pre-update row."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        row = self._d.get(key)
        if row is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return row

    def put(self, key, row: np.ndarray):
        if self.capacity <= 0:
            return
        self._d[key] = row
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def invalidate(self, keys):
        for k in keys:
            self._d.pop(k, None)

    def __len__(self):
        return len(self._d)


class SparseBinding:
    """One ``lookup_table_sparse`` site resolved against its table."""

    __slots__ = ("table", "ids_name", "rows_name", "inv_name",
                 "grad_name", "vocab_size", "dim")

    def __init__(self, table: SparseTable, ids_name: str, rows_name: str,
                 inv_name: str, vocab_size: int, dim: int):
        self.table = table
        self.ids_name = ids_name
        self.rows_name = rows_name
        self.inv_name = inv_name
        self.grad_name = rows_name + "@GRAD"
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)


def _next_pow2(n: int, floor: int = 8) -> int:
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


class SparseSession:
    """Binds host tables to a program's ``lookup_table_sparse`` sites and
    runs the pull/push rim around executor dispatches.

    ``tables``: a :class:`SparseTable`, a sequence of them, or a
    ``{name: table}`` dict — every sparse site in the bound program must
    resolve to one.  ``cache_rows`` bounds the hot-rows cache (0 = off).
    ``retry_policy`` (a :class:`paddle_tpu_torch.faults.RetryPolicy`) makes a
    transient push failure retry with backoff; without one it raises —
    either way a dropped push is never silent.  Each batch's unique-id
    count is padded up to a power of two (at least ``bucket_floor``) so
    the captured step's key stays stable (PAD slots pull zero rows and
    push nothing).

    ``prefetch_depth``, ``async_push`` and ``push_flush_batch`` are the
    overlap knobs (module docstring); ``cache_rows``,
    ``prefetch_depth`` and ``push_flush_batch`` left at ``None`` take
    the declared defaults (0 / 0 / 1) or, under the ``autotune`` flag,
    the persisted ``sparse/hot_rows`` / ``sparse/prefetch`` /
    ``sparse/push_flush`` winners.
    """

    def __init__(self, tables, *, cache_rows: Optional[int] = None,
                 retry_policy=None, bucket_floor: int = 8,
                 prefetch_depth: Optional[int] = None,
                 async_push: int = 0,
                 push_flush_batch: Optional[int] = None,
                 observe: Optional[bool] = None):
        if isinstance(tables, SparseTable) or (
                hasattr(tables, "pull") and hasattr(tables, "push")
                and hasattr(tables, "name")):
            # one table, in-process or remote — RemoteSparseTable duck-
            # types the SparseTable surface and binds identically (the
            # wire tier stays lazy: no isinstance on a gated import)
            tables = [tables]
        if isinstance(tables, dict):
            self.tables: Dict[str, SparseTable] = dict(tables)
        else:
            self.tables = {t.name: t for t in tables}
        for name, t in self.tables.items():
            if name != t.name:
                raise ValueError(
                    f"SparseSession: table dict key {name!r} != "
                    f"table.name {t.name!r}")
        self.retry_policy = retry_policy
        self.bucket_floor = int(bucket_floor)
        if cache_rows is None:
            cache_rows = _tuned_knob("sparse/hot_rows",
                                     {"cache_rows": 0}, "cache_rows")
        if prefetch_depth is None:
            prefetch_depth = _tuned_knob("sparse/prefetch", {"depth": 0},
                                         "depth")
        if push_flush_batch is None:
            push_flush_batch = _tuned_knob("sparse/push_flush",
                                           {"batch": 1}, "batch")
        self.cache = HotRowCache(cache_rows)
        self.prefetch_depth = int(prefetch_depth)
        self.async_push = int(async_push)
        self.push_flush_batch = max(1, int(push_flush_batch))
        self._observe = obs.enabled() if observe is None else bool(observe)
        self._bindings: List[SparseBinding] = []
        # bound-program memo: a WEAKREF, not id() — a dead program's
        # reused allocation must never short-circuit a rebind
        self._bound_ref = None
        self._bound_version = None
        self._push_gen = 0          # bumped per push; fences cache fills
        self._lock = _lw.make_lock("sparse.session")
        self._pending: "collections.deque" = collections.deque()
        # async-push worker state (guarded by _push_cv; the worker is
        # spawned on demand and exits after a bounded idle linger, so
        # sessions never leak threads without an explicit close)
        self._push_cv = _lw.make_condition("sparse.session.push")
        self._push_q: "collections.deque" = collections.deque()
        self._push_inflight = 0
        self._push_worker = None
        self._push_err = None
        self._push_linger_s = _PUSH_LINGER_S
        # lifetime counters (always maintained; mirrored into the
        # observability registry only when observing)
        self.stats = {"pulls": 0, "pulled_rows": 0, "pushes": 0,
                      "pushed_rows": 0, "pull_ms": 0.0, "push_ms": 0.0,
                      "batches": 0, "prefetch_hits": 0,
                      "prefetch_misses": 0, "push_flushes": 0,
                      "push_flush_ms": 0.0}

    # -- binding ------------------------------------------------------------
    def bind(self, program) -> "SparseSession":
        """Discover the program's sparse sites and resolve each against
        its table (idempotent per live program + version)."""
        if self._bound_ref is not None \
                and self._bound_ref() is program \
                and self._bound_version == program.version:
            return self
        bindings = []
        for b in program.blocks:
            for op in b.ops:
                if op.type != SPARSE_OP:
                    continue
                name = op.attrs["table_name"]
                table = self.tables.get(name)
                if table is None:
                    raise KeyError(
                        f"program declares sparse table {name!r} but the "
                        f"session only has {sorted(self.tables)} — build "
                        f"one (sparse.tables_for_program) and pass it in")
                vocab = int(op.attrs["vocab_size"])
                dim = int(op.attrs["dim"])
                if (table.vocab_size, table.dim) != (vocab, dim):
                    raise ValueError(
                        f"sparse table {name!r}: program declares "
                        f"vocab={vocab} dim={dim} but the table carries "
                        f"vocab={table.vocab_size} dim={table.dim}")
                bindings.append(SparseBinding(
                    table, op.input("Ids")[0], op.input("Rows")[0],
                    op.input("Inverse")[0], vocab, dim))
        if not bindings:
            raise ValueError(
                "SparseSession.bind: program has no lookup_table_sparse "
                "ops — build embeddings with layers.embedding(..., "
                "sparse=True)")
        self._bindings = bindings
        self._bound_ref = weakref.ref(program)
        self._bound_version = program.version
        return self

    @property
    def bindings(self) -> List[SparseBinding]:
        return list(self._bindings)

    @property
    def grad_fetch_list(self) -> List[str]:
        """``<rows>@GRAD`` fetch names, in binding order — append these
        to the training fetch list and hand the fetched arrays back to
        :meth:`complete`."""
        return [b.grad_name for b in self._bindings]

    # -- id plumbing --------------------------------------------------------
    def _coerce_ids(self, b: SparseBinding, raw) -> np.ndarray:
        ids = np.asarray(raw)
        if ids.dtype == object:
            raise ValueError(
                f"sparse feed {b.ids_name!r} (table {b.table.name!r}): "
                f"ids arrived as a ragged/mixed object array — feed a "
                f"rectangular int32/int64 array (canonical dtype int64)")
        if ids.dtype.kind not in "iu":
            raise ValueError(
                f"sparse feed {b.ids_name!r} (table {b.table.name!r}): "
                f"ids must be integral (canonical dtype int64), got "
                f"{ids.dtype.name}")
        ids = ids.astype(np.int64, copy=False)
        if ids.ndim >= 2 and ids.shape[-1] == 1:
            ids = ids[..., 0]          # the [..., 1] id convention
        if ids.size:
            lo, hi = int(ids.min()), int(ids.max())
            if lo < 0 or hi >= b.vocab_size:
                bad = lo if lo < 0 else hi
                raise ValueError(
                    f"sparse feed {b.ids_name!r} (table "
                    f"{b.table.name!r}): id {bad} outside the declared "
                    f"vocab [0, {b.vocab_size}) — fix the feature "
                    f"hashing/vocab map before it reaches the gather")
        return ids

    def _pull_rows(self, b: SparseBinding, uid: np.ndarray) -> np.ndarray:
        """Cache-first pull of the (bucketed) unique ids."""
        table, cache = b.table, self.cache
        t0 = time.perf_counter()
        hits0, misses0 = cache.hits, cache.misses
        init0, last_init0 = table.rows_initialized, table.last_init
        if cache.capacity > 0:
            out = np.zeros((len(uid), table.dim), table.dtype)
            missing_pos: List[int] = []
            with self._lock:
                for j, i in enumerate(uid.tolist()):
                    if i == PAD_ID:
                        continue
                    row = cache.get((table.name, i))
                    if row is None:
                        missing_pos.append(j)
                    else:
                        out[j] = row
            if missing_pos:
                # the table pull runs OUTSIDE the session lock (it can
                # be slow); a push may land between it and the cache
                # insert below.  _push_gen (bumped under the lock by
                # every push) fences the insert: rows pulled before a
                # concurrent push are NOT cached — caching them after
                # the push's invalidate would pin a pre-update row,
                # breaking the cache's never-stale invariant.
                with self._lock:
                    gen0 = self._push_gen
                miss_ids = uid[missing_pos]
                rows = table.pull(miss_ids)
                out[missing_pos] = rows
                with self._lock:
                    if self._push_gen == gen0:
                        for j, i in zip(range(len(miss_ids)),
                                        miss_ids.tolist()):
                            cache.put((table.name, i), rows[j].copy())
        else:
            out = table.pull(uid)
        live = int((uid != PAD_ID).sum())
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.stats["pulls"] += 1
        self.stats["pulled_rows"] += live
        self.stats["pull_ms"] += dt_ms
        if self._observe:
            obs.inc_counter("sparse/pulls")
            obs.inc_counter("sparse/pulled_rows", live)
            obs.observe_hist("sparse/pull_ms", dt_ms)
            obs.set_gauge("sparse/live_rows", table.live_rows,
                          label=table.name)
            # counter: the total-preserving delta (a push worker's inits
            # may land in this window, but every row is counted once);
            # rate gauge: the table's atomically rebound last-init tuple
            d_init = table.rows_initialized - init0
            if d_init:
                obs.inc_counter("sparse/rows_initialized", d_init)
            li = table.last_init
            if li is not None and li is not last_init0 and li[1] > 0:
                obs.set_gauge("sparse/init_rows_per_sec", li[0] / li[1],
                              label=table.name)
            if cache.capacity > 0:
                dh = cache.hits - hits0
                dm = cache.misses - misses0
                if dh:
                    obs.inc_counter("sparse/cache_hits", dh)
                if dm:
                    obs.inc_counter("sparse/cache_misses", dm)
        return out

    # -- the rim ------------------------------------------------------------
    def prepare_feed(self, feed: Dict[str, object],
                     is_test: bool = False,
                     trace_parent=None) -> Dict[str, object]:
        """Dedup + pull + inject for one batch.  Returns a NEW feed dict
        carrying the original entries plus each binding's rows and
        inverse-index feeds.  Training batches (``is_test=False``)
        enqueue their unique-id sets for the matching :meth:`complete`.
        Read-only batches (``is_test=True``) first :meth:`flush` any
        queued async pushes — the hard barrier that keeps ``test()``
        and serving reads from seeing a table missing acked updates.
        ``trace_parent``: the ``sparse/pull`` span's parent for a caller
        on another thread (the prefetch worker).
        """
        if not self._bindings:
            raise RuntimeError("SparseSession: call bind(program) first")
        if self.async_push > 0:
            if is_test:
                self.flush()
            else:
                self._raise_push_err()
        out = dict(feed)
        pend = []
        with (span("sparse/pull", parent=trace_parent,
                   tables=len(self._bindings))
              if self._observe else nullcontext()):
            for b in self._bindings:
                if b.ids_name not in feed:
                    raise KeyError(
                        f"sparse feed {b.ids_name!r} (table "
                        f"{b.table.name!r}) missing from the batch feed "
                        f"(have: {sorted(feed)})")
                ids = self._coerce_ids(b, feed[b.ids_name])
                uniq, inv = np.unique(ids.reshape(-1),
                                      return_inverse=True)
                n = max(len(uniq), 1)
                cap = _next_pow2(n, self.bucket_floor)
                uid = np.full(cap, PAD_ID, np.int64)
                uid[:len(uniq)] = uniq
                out[b.rows_name] = self._pull_rows(b, uid)
                out[b.inv_name] = inv.reshape(ids.shape).astype(np.int32)
                if not is_test:
                    pend.append((b, uid))
        if pend:
            with self._lock:
                self._pending.append(pend)
        self.stats["batches"] += 1
        return out

    def complete(self, grad_arrays: Sequence):
        """Push one batch's gradient rows (the fetched ``<rows>@GRAD``
        arrays, in :attr:`grad_fetch_list` order) back into the tables.
        Synchronous mode returns rows updated; with ``async_push > 0``
        the push is ACKNOWLEDGED by enqueueing it (bounded at
        ``async_push`` batches; blocks when full) and applied FIFO on
        the worker — :meth:`flush` is the completion barrier, and a
        worker failure re-raises here or there, never silently."""
        with self._lock:
            if not self._pending:
                raise RuntimeError(
                    "SparseSession.complete: no pending batch — "
                    "prepare_feed/complete must alternate FIFO")
            pend = self._pending.popleft()
        if len(grad_arrays) != len(pend):
            raise ValueError(
                f"SparseSession.complete: got {len(grad_arrays)} grad "
                f"arrays for {len(pend)} bound tables")
        if self.async_push > 0:
            with self._push_cv:
                self._raise_push_err_locked()
                while len(self._push_q) >= self.async_push \
                        and self._push_err is None:
                    self._push_cv.wait()
                self._raise_push_err_locked()
                self._push_q.append((pend, list(grad_arrays)))
                if self._push_worker is None:
                    t = threading.Thread(
                        target=self._push_worker_main,
                        name=f"{THREAD_NAME_PREFIX}-push", daemon=True)
                    self._push_worker = t
                    t.start()
                self._push_cv.notify_all()
            return None
        updated = 0
        with (span("sparse/push", tables=len(pend))
              if self._observe else nullcontext()):
            for (b, uid), g in zip(pend, grad_arrays):
                updated += self._push(b, uid, np.asarray(g, b.table.dtype))
        return updated

    # -- async push worker --------------------------------------------------
    def _raise_push_err_locked(self):
        if self._push_err is not None:
            e, self._push_err = self._push_err, None
            raise e

    def _raise_push_err(self):
        with self._push_cv:
            self._raise_push_err_locked()

    def _push_worker_main(self):
        while True:
            with self._push_cv:
                if not self._push_q:
                    self._push_cv.wait(timeout=self._push_linger_s)
                    if not self._push_q:
                        self._push_worker = None
                        self._push_cv.notify_all()
                        return
                take = min(len(self._push_q), self.push_flush_batch)
                group = [self._push_q.popleft() for _ in range(take)]
                self._push_inflight += len(group)
                self._push_cv.notify_all()   # unblock bounded producers
            t0 = time.perf_counter()
            try:
                for pend, grads in group:
                    with (span("sparse/push", tables=len(pend))
                          if self._observe else nullcontext()):
                        for (b, uid), g in zip(pend, grads):
                            self._push(b, uid,
                                       np.asarray(g, b.table.dtype))
            except BaseException as e:       # noqa: BLE001 — re-raised
                # at the next complete/flush/export rim; queued pushes
                # after a failure are DROPPED with the error carrying
                # the loss (the run must abort: grads exist nowhere
                # else, continuing would train on a corrupt table)
                with self._push_cv:
                    self._push_err = e
                    self._push_q.clear()
                    self._push_inflight = 0
                    self._push_worker = None
                    self._push_cv.notify_all()
                return
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.stats["push_flushes"] += 1
            self.stats["push_flush_ms"] += dt_ms
            if self._observe:
                obs.observe_hist("sparse/push_flush_ms", dt_ms)
            with self._push_cv:
                self._push_inflight -= len(group)
                self._push_cv.notify_all()

    def flush(self):
        """Barrier: block until every acknowledged (enqueued) async push
        has been APPLIED to the tables, re-raising a worker failure.
        No-op in synchronous mode."""
        if self.async_push <= 0:
            return
        with self._push_cv:
            while (self._push_q or self._push_inflight) \
                    and self._push_err is None:
                self._push_cv.wait()
            self._raise_push_err_locked()

    @property
    def pending_batches(self) -> int:
        with self._lock:
            return len(self._pending)

    def _push(self, b: SparseBinding, uid: np.ndarray,
              grads: np.ndarray) -> int:
        t0 = time.perf_counter()

        def attempt():
            if _fi.ENABLED:
                action = _fi.check("sparse.push")
                if action is not None:
                    _fi.raise_for(action, "sparse.push")
            return b.table.push(uid, grads)

        def on_retry(i, e, d):
            obs.inc_counter("fault/retries")
            obs.emit_event("fault", event="retry", site="sparse.push",
                           attempt=i + 1, delay_s=round(d, 4),
                           error=f"{type(e).__name__}: {e}")

        if self.retry_policy is not None:
            n = _faults.retry_call(
                attempt, self.retry_policy,
                what=f"sparse push {b.table.name}", on_retry=on_retry)
        else:
            # no policy: a failed push raises — the grads for these rows
            # exist nowhere else, so losing them silently would corrupt
            # the table's training trajectory undetectably
            n = attempt()
        if self.cache.capacity > 0:
            with self._lock:
                self._push_gen += 1      # fence in-flight cache fills
                self.cache.invalidate(
                    (b.table.name, i) for i in uid.tolist()
                    if i != PAD_ID)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.stats["pushes"] += 1
        self.stats["pushed_rows"] += n
        self.stats["push_ms"] += dt_ms
        if self._observe:
            obs.inc_counter("sparse/pushes")
            obs.inc_counter("sparse/pushed_rows", n)
            obs.observe_hist("sparse/push_ms", dt_ms)
        return n

    # -- pull-ahead prefetch ------------------------------------------------
    def prefetch_feeds(self, feed_iter, *, depth: Optional[int] = None,
                       is_test: bool = False):
        """Pull-ahead rim over a stream of raw feed dicts: yields
        prepared feeds (each the result of :meth:`prepare_feed`) while a
        worker thread prepares up to ``depth`` batches ahead — batch
        N+1's row pulls overlap batch N's dispatch.  ``depth`` defaults
        to the session's ``prefetch_depth``; ``depth <= 0`` prepares
        inline (no thread, bit-identical to the synchronous rim).

        Closing the returned generator stops and joins the worker; a
        worker failure (bad feed, table error) re-raises at the
        consumer.  FIFO is preserved end to end, so the pending-batch
        queue stays aligned with :meth:`complete`."""
        depth = self.prefetch_depth if depth is None else int(depth)
        if depth <= 0:
            def _inline():
                for f in feed_iter:
                    yield self.prepare_feed(f, is_test=is_test)
            return _inline()
        return self._prefetch_gen(feed_iter, depth, is_test)

    def _prefetch_gen(self, feed_iter, depth: int, is_test: bool):
        # A producer/consumer of its own rather than
        # reader.pipeline.prefetch: this rim needs the hit/miss
        # accounting and the close-time retraction of the pending
        # entries below, which the shared reader does not expose.
        # ``slots`` bounds the lead: the worker takes one before it
        # pulls and the consumer gives one back as it takes a batch, so
        # no pull runs more than ``depth`` batches ahead of the batch
        # the consumer holds (a bounded queue alone would let the
        # worker pull one more while it waits to put)
        q = _queue_mod.Queue()
        slots = threading.Semaphore(depth)
        stop = threading.Event()
        prepared_n = [0]                     # batches the worker prepared
        delivered_n = 0                      # batches the consumer got
        root = (start_span("sparse/prefetch", depth=depth)
                if self._observe else None)

        def _take_slot() -> bool:
            while not stop.is_set():
                if slots.acquire(timeout=0.1):
                    return True
            return False

        def _work():
            try:
                for f in feed_iter:
                    if not _take_slot():
                        return
                    prepared = self.prepare_feed(f, is_test=is_test,
                                                 trace_parent=root)
                    prepared_n[0] += 1
                    q.put(("ok", prepared))
                q.put(("done", None))
            except BaseException as e:       # noqa: BLE001 — re-raised
                q.put(("err", e))            # at the consumer

        t = threading.Thread(target=_work,
                             name=f"{THREAD_NAME_PREFIX}-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                try:
                    kind, val = q.get_nowait()
                    hit = True
                except _queue_mod.Empty:
                    hit = False
                    kind, val = q.get()
                if kind == "done":
                    break
                if kind == "err":
                    raise val
                self.stats["prefetch_hits" if hit
                           else "prefetch_misses"] += 1
                if self._observe:
                    if hit:
                        obs.inc_counter("sparse/prefetch_hits")
                    else:
                        obs.inc_counter("sparse/prefetch_misses")
                delivered_n += 1
                slots.release()
                yield val
        finally:
            stop.set()                       # a worker waiting for a
            t.join(timeout=10.0)             # slot sees it within 0.1 s
            if not is_test and not t.is_alive():
                # retract the pending-push entries of batches prepared
                # ahead but never DELIVERED to the consumer: leaving
                # them would misalign a reused session's next
                # complete() with the wrong unique-id set (delivered
                # batches keep theirs — same state as a synchronous
                # abort after prepare_feed)
                with self._lock:
                    for _ in range(prepared_n[0] - delivered_n):
                        self._pending.pop()
            if root is not None:
                root.end()

    # -- convenience --------------------------------------------------------
    def run(self, exe, program, feed: Dict[str, object],
            fetch_list: Sequence, scope=None, is_test: bool = False,
            return_numpy: bool = True) -> List:
        """One pull → dispatch → push round through ``exe.run`` — the
        standalone form of the trainer wiring (benchmarks, scripts)."""
        self.bind(program)
        feed = self.prepare_feed(feed, is_test=is_test)
        names = [getattr(v, "name", v) for v in fetch_list]
        if is_test:
            return exe.run(program, feed=feed, fetch_list=names,
                           scope=scope, return_numpy=return_numpy,
                           is_test=True)
        out = exe.run(program, feed=feed,
                      fetch_list=names + self.grad_fetch_list,
                      scope=scope, return_numpy=return_numpy)
        self.complete(out[len(names):])
        return out[:len(names)]

    # -- cache accounting ---------------------------------------------------
    def cache_stats(self) -> dict:
        c = self.cache
        total = c.hits + c.misses
        return {"capacity": c.capacity, "entries": len(c),
                "hits": c.hits, "misses": c.misses,
                "hit_rate": (c.hits / total) if total else None}

    # -- checkpoint rider ---------------------------------------------------
    def export_state_vars(self) -> Dict[str, np.ndarray]:
        """All bound tables' state as synthetic scope vars — what a
        ``Checkpointer(sparse=...)`` commits when the tables keep no
        dirty rows.  Flushes
        queued async pushes FIRST: every push acknowledged before a
        checkpoint commit is in the committed state."""
        self.flush()
        out: Dict[str, np.ndarray] = {}
        for t in self.tables.values():
            out.update(t.export_state_vars())
        return out

    # -- incremental checkpoint (delta-source surface) ----------------------
    # The Checkpointer's delta source duck-type: export_delta/export_full
    # return (tokens, state); commit_delta acks after the durable write,
    # retract_delta re-dirties on writer failure.  Same flush-first
    # barrier as export_state_vars: every acked async push is in the
    # snapshot before the dirty set is cleared.
    @property
    def supports_delta(self) -> bool:
        return all(hasattr(t, "export_delta")
                   for t in self.tables.values())

    @property
    def dirty_rows(self) -> int:
        """Rows the next delta commit would export across all tables."""
        return sum(t.dirty_rows for t in self.tables.values())

    def export_delta(self):
        """Dirty rows of every bound table as ``(tokens, state)`` —
        ``tokens`` maps table name -> pending-set token."""
        self.flush()
        tokens: Dict[str, int] = {}
        out: Dict[str, np.ndarray] = {}
        for name, t in self.tables.items():
            tok, st = t.export_delta()
            tokens[name] = tok
            out.update(st)
        return tokens, out

    def export_full(self):
        """Full table state under the same token protocol — the rebase
        form (dirty set snapshotted atomically with the export)."""
        self.flush()
        tokens: Dict[str, int] = {}
        out: Dict[str, np.ndarray] = {}
        for name, t in self.tables.items():
            tok, st = t.export_full()
            tokens[name] = tok
            out.update(st)
        return tokens, out

    def commit_delta(self, tokens: Dict[str, int]):
        for name, tok in (tokens or {}).items():
            t = self.tables.get(name)
            if t is not None:
                t.commit_delta(tok)

    def retract_delta(self, tokens: Dict[str, int]):
        for name, tok in (tokens or {}).items():
            t = self.tables.get(name)
            if t is not None:
                t.retract_delta(tok)

    def restore_from_scope(self, scope) -> bool:
        """Pop ``__sparse__/...`` vars a Checkpointer restore left in
        ``scope`` and load them into the bound tables.  Returns False
        when the scope carries no sparse state (fresh start)."""
        keys = [k for k in list(scope.keys())
                if k.startswith("__sparse__/")]
        if not keys:
            return False
        state = {k: scope.get(k) for k in keys}
        for t in self.tables.values():
            t.restore_state_vars(state)
        for k in keys:
            scope.delete(k)
        return True

    # -- serving ------------------------------------------------------------
    def serving_model(self, model, name: Optional[str] = None):
        """Wrap a :class:`paddle_tpu_torch.serving.Model` so each request batch
        pulls its rows (cache-first) at request time — the train→serve
        CTR wiring.  The wrapped model's visible inputs are the ids/dense
        features only; the rows/inverse feeds are injected inside."""
        from ..serving.model import Model  # lazy: serving stays unloaded

        if not self._bindings:
            raise RuntimeError(
                "SparseSession.serving_model: call bind(program) first")
        injected = {n for b in self._bindings
                    for n in (b.rows_name, b.inv_name)}
        inner = model

        def fn(feeds):
            prepared = self.prepare_feed(dict(feeds), is_test=True)
            return inner(prepared)

        specs = {k: v for k, v in inner.input_specs.items()
                 if k not in injected} or None
        example = None
        if inner.example:
            example = {k: v for k, v in inner.example.items()
                       if k not in injected} or None
        return Model(name or f"{inner.name}-sparse", fn,
                     input_specs=specs, output_names=inner.output_names,
                     example=example)
