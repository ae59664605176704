"""Checkpoints with integrity metadata, an async writer and delta chains
(counterpart of ``paddle_tpu/distributed/checkpoint.py``; reference:
go/pserver/service.go:120-227, the pserver's periodic checkpoint with
md5s recorded beside it and recover-on-restart from the newest valid
one).

The layout on disk is the JAX package's, so each package restores what
the other wrote::

    <root>/ckpt-<step>/
        <var>.p<proc>s<k>.npy   one piece of a var (np.save); bfloat16
                                as its raw 16-bit words
        <var>.p<proc>s<k>.patch the changed chunks of a delta commit
        shards-<proc>.json      the process's manifest (with the nonce)
        meta.json               shapes, dtypes, md5s, the shard index,
                                the chain fields; written last: the
                                commit point

A commit is written into ``ckpt-<step>.tmp`` and renamed into place.  A
commit is a full base or a delta: a delta records, for each dense var,
the sha256 table of its fixed-size chunks and writes only the chunks
that changed since its parent, which it names by content hash; restore
replays base to tip, and any broken or corrupt link fails the whole tip.
A sparse table's rows (``__sparse__/<table>/shard<k>/{ids,rows,slot/*}``,
``sparse/table.py``) are written whole in each commit (mode
``sparse``): a delta holds the rows pushed since its parent, and replay
merges each shard group by id, later rows over earlier ones.  Sparse
vars restore as host numpy arrays: the table lives on the host.

``save`` copies the scope to the host on the calling thread, after the
card has finished every queued step, into arrays the snapshot owns (a
captured step rewrites its state buffers in place, and a CPU tensor's
``numpy()`` is a view), and a writer thread serializes, fsyncs and
commits them (one queued commit: the trainer snapshots commit N+1 while
N writes).  A writer failure is held and raised by the next ``save`` or
``wait`` on the caller's thread.  ``restore`` takes the newest intact
commit, falling back past corrupt ones, and puts each var back in the
dtype and on the device of the tensor the scope holds (else the file's
dtype on the manager's device): an int64 counter that the JAX package
wrote as int32 comes back int64.

One process writes everything, unless ``torch.distributed`` is
initialized: then process 0 writes every var (the port's processes hold
replicas) and the others wait for its commit.  Not ported: restoring a
var stored in several pieces (a sharded JAX checkpoint; ROADMAP Queue A
item 7), which raises.

Observability: each durable commit observes ``checkpoint/commit_ms``,
counts delta bytes and rows or a rebase, and writes a ``ckpt`` event; a
restore that skips a corrupt commit counts
``fault/checkpoint_fallbacks``.  The writer's locks come from the lock
watch.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import observability as obs
from ..core.scope import Scope, global_scope
from ..testing import faultinject as _fi
from ..testing import lockwatch as _lw

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["CheckpointManager", "CheckpointTimeoutError", "DeltaChainError",
           "save_checkpoint", "load_checkpoint", "DEFAULT_CHUNK_BYTES"]

# default for the cross-process commit/manifest barrier (overridable per
# manager and via PADDLE_TPU_CKPT_TIMEOUT_S)
DEFAULT_BARRIER_TIMEOUT_S = 600.0

#: fixed chunk size for dense-var diffing in delta commits
DEFAULT_CHUNK_BYTES = 1 << 20

#: thread-name prefix of the async commit writer, which exits after an
#: idle linger
THREAD_NAME_PREFIX = "pt-ckpt"

_WRITER_LINGER_S = 0.5

_SPARSE_PREFIX = "__sparse__/"


class CheckpointTimeoutError(TimeoutError):
    """A checkpoint file barrier (the shard-manifest wait or the commit
    wait) timed out.  ``tag`` names the barrier, ``timeout_s`` the
    budget that lapsed."""

    def __init__(self, tag: str, timeout_s: float):
        super().__init__(
            f"checkpoint barrier timed out after {timeout_s:g}s: {tag}")
        self.tag = tag
        self.timeout_s = timeout_s


class DeltaChainError(RuntimeError):
    """A delta commit cannot chain: no live committed parent, or a
    multi-process run.  Callers fall back to a full rebase."""


def _sparse_group(name: str) -> Optional[Tuple[str, str]]:
    """``__sparse__/<t>/shard<k>/<member>`` -> (group prefix, member);
    None for everything else (the per-table ``/meta`` blob included,
    which a commit replaces whole)."""
    if not name.startswith(_SPARSE_PREFIX):
        return None
    parts = name.split("/")
    if len(parts) >= 4 and parts[2].startswith("shard"):
        return "/".join(parts[:3]), "/".join(parts[3:])
    return None


# ---------------------------------------------------------------------------
# host arrays: numpy has no bfloat16, so it travels as its 16-bit words
# ---------------------------------------------------------------------------
def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a var of dtype ``name`` is held in on the host."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _as_storage(arr: np.ndarray, name: str) -> np.ndarray:
    """A loaded piece re-viewed as its storage dtype (np.save writes an
    extension dtype such as the JAX package's bfloat16 as raw void
    bytes)."""
    want = _storage_dtype(name)
    return arr if arr.dtype == want else arr.view(want)


def _host_piece(value) -> Tuple[np.ndarray, str]:
    """(a host array the caller owns, the dtype name) of a scope value."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            name = "bfloat16"
        else:
            name = str(t.dtype).replace("torch.", "")
        arr = t.cpu().numpy() if t.device.type != "cpu" else \
            t.clone().numpy()
        if name == "bfloat16":
            arr = arr.view(np.uint16)
        return arr, name
    arr = np.array(value, copy=True)
    return arr, arr.dtype.name


def _to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _whole_index(shape):
    return [[0, int(d)] for d in shape]


def _file_md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _chunk_hashes(raw, chunk_bytes: int) -> List[str]:
    """sha256 per fixed-size chunk of ``raw`` (the last chunk may be
    short).  An empty buffer has an empty table."""
    mv = memoryview(raw)
    return [hashlib.sha256(mv[o:o + chunk_bytes]).hexdigest()
            for o in range(0, len(mv), chunk_bytes)]


def _meta_content_hash(meta: dict) -> str:
    """A commit's content hash: sha256 over the canonical JSON of its
    meta without the hash field.  The meta holds every file's md5 and
    the parent's hash, so the hash commits to the whole chain."""
    doc = {k: v for k, v in meta.items() if k != "content_hash"}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode("utf-8")).hexdigest()


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    """Commits and restores scopes under ``root``.

    ``max_to_keep`` newest commits are kept (a kept delta keeps every
    ancestor it replays through).  ``async_save`` writes on the writer
    thread.  ``device``: where a restored var goes when the scope holds
    no tensor of that name (default the card, ``cuda``; pass ``"cpu"``
    for the CPU).  ``process_index``/``process_count``/``barrier``
    inject the multi-process identity and barrier (by default
    ``torch.distributed``'s when it is initialized, else one process).

    ``last_snapshot`` holds the last save's ``{"ms", "bytes"}`` (the
    calling thread's copy to the host), ``commits`` each commit's
    ``{"step", "kind", "bytes", "ms"}`` (the writer's serialization,
    hashes, fsyncs and rename) and ``last_restore_ms`` the last
    restore's time."""

    def __init__(self, root: str, max_to_keep: int = 3,
                 async_save: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, barrier=None,
                 barrier_timeout_s: Optional[float] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES, device=None):
        self.root = root
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.chunk_bytes = int(chunk_bytes)
        self.device = device
        if barrier_timeout_s is None:
            env = os.environ.get("PADDLE_TPU_CKPT_TIMEOUT_S")
            barrier_timeout_s = float(env) if env \
                else DEFAULT_BARRIER_TIMEOUT_S
        self.barrier_timeout_s = float(barrier_timeout_s)
        if (process_index is None) != (process_count is None):
            raise ValueError(
                "process_index and process_count must be injected together")
        self._process_index = process_index
        self._process_count = process_count
        self._barrier = barrier
        # the writer: a FIFO of at most one queued job, drained by a
        # thread that exits after an idle linger; a failure is held and
        # raised on the caller's thread by the next save()/wait()
        self._wcv = _lw.make_condition("checkpoint.writer")
        self._wq: List[dict] = []
        self._winflight: Optional[dict] = None
        self._wthread: Optional[threading.Thread] = None
        self._writer_linger_s = _WRITER_LINGER_S
        self._write_failure: Optional[BaseException] = None
        # delta-chain state (one process only): _committed is the durable
        # tip's meta, which the next delta diffs against; _planned_* is
        # the caller's view while a write is in flight
        self._chain_lock = _lw.make_lock("checkpoint.chain")
        self._committed: Optional[dict] = None
        self._planned_alive = False
        self._planned_len = 0
        self.last_snapshot: Optional[dict] = None
        self.commits: List[dict] = []
        self.last_restore_ms: Optional[float] = None
        os.makedirs(root, exist_ok=True)

    def _proc(self):
        if self._process_index is not None:
            return self._process_index, self._process_count
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1

    def _sync(self, tag: str):
        if self._barrier is not None:
            self._barrier(tag)
            return
        torch.distributed.barrier()

    # -- delta-chain surface -------------------------------------------------
    def delta_supported(self) -> bool:
        """Delta commits are single-process."""
        return self._proc()[1] == 1

    def chain_stats(self) -> dict:
        """The rebase policy's inputs: ``alive`` (a chainable tip exists,
        committed or planned by a write in flight), ``len`` (the planned
        chain length), ``bytes`` (delta bytes since the last committed
        base) and ``base_bytes`` (that base's size)."""
        with self._chain_lock:
            tip = self._committed
            return {"alive": self._planned_alive,
                    "len": self._planned_len,
                    "bytes": 0 if tip is None else int(
                        tip.get("chain_bytes", 0)),
                    "base_bytes": 0 if tip is None else int(
                        tip.get("base_bytes", 0))}

    def _adopt_tip(self, meta: Optional[dict]):
        if self._proc()[1] != 1:
            return
        with self._chain_lock:
            chainable = bool(meta and meta.get("content_hash"))
            self._committed = meta if chainable else None
            self._planned_alive = chainable
            self._planned_len = int(meta.get("chain_len", 0)) \
                if chainable else 0

    # -- save ----------------------------------------------------------------
    def _snapshot(self, scope: Scope, var_names=None) -> dict:
        """{name: (shape, dtype name, [(index, host array)])} of the
        scope, in arrays the snapshot owns.  Every card holding a value
        is synchronized first, so the copies see every step queued
        before the call (a captured step's replay rewrites its buffers
        in place)."""
        names = var_names or scope.keys()
        vals = {n: scope.get(n) for n in names if scope.has(n)}
        for dev in {v.device for v in vals.values()
                    if isinstance(v, torch.Tensor) and v.is_cuda}:
            torch.cuda.synchronize(dev)
        snap = {}
        proc, _ = self._proc()
        for n, v in vals.items():
            arr, dtype = _host_piece(v)
            # one piece a var, written by process 0 (replicas elsewhere)
            pieces = [(_whole_index(arr.shape), arr)] if proc == 0 else []
            snap[n] = (tuple(arr.shape), dtype, pieces)
        return snap

    def save(self, step: int, scope: Optional[Scope] = None,
             var_names=None, blocking: bool = False, kind: str = "full",
             on_commit: Optional[Callable[[dict], None]] = None,
             on_fail: Optional[Callable[[BaseException], None]] = None):
        """Snapshot ``scope`` on this thread and commit it, on the writer
        thread unless ``blocking`` (or ``async_save=False``).
        ``kind="delta"`` chains onto the committed tip and needs a live
        single-process chain and a tip of another step (a re-save of the
        tip's step replaces the tip): :class:`DeltaChainError` otherwise,
        before anything is written.  ``on_commit(info)`` runs after the durable
        commit, ``on_fail(exc)`` if the write fails or is dropped
        behind an earlier failed one."""
        if kind not in ("full", "delta"):
            raise ValueError(f"save kind must be 'full' or 'delta', "
                             f"got {kind!r}")
        scope = global_scope() if scope is None else scope
        _, nprocs = self._proc()
        self._raise_write_failure()
        # a re-save of a pending step must not race the writer inside the
        # same tmp dir: drain first
        if step in self._pending_steps():
            self.wait()
        if kind == "delta":
            if nprocs != 1:
                raise DeltaChainError(
                    "delta commits are single-process; multi-process "
                    "runs keep the full-save protocol")
            with self._chain_lock:
                if not self._planned_alive:
                    raise DeltaChainError(
                        "no live parent chain (nothing committed or the "
                        "last write failed): commit a full rebase")
                tip = self._committed
                if tip is not None and tip.get("step") == step:
                    # the commit replaces its own parent's directory
                    raise DeltaChainError(
                        f"ckpt-{step} would chain onto the commit it "
                        f"replaces: commit a full rebase")
        t0 = time.perf_counter()
        snap = self._snapshot(scope, var_names)
        self.last_snapshot = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": sum(a.nbytes for _, _, ps in snap.values()
                         for _, a in ps)}
        nonce = self._begin_attempt(step)
        job = {"step": step, "snap": snap, "nonce": nonce, "kind": kind,
               "on_commit": on_commit, "on_fail": on_fail}
        if nprocs == 1:
            with self._chain_lock:
                if kind == "delta":
                    self._planned_len += 1
                else:
                    self._planned_alive = True
                    self._planned_len = 0
        if self.async_save and not blocking:
            with self._wcv:
                self._raise_write_failure_locked()
                while self._wq and self._write_failure is None:
                    self._wcv.wait()
                self._raise_write_failure_locked()
                self._wq.append(job)
                if self._wthread is None:
                    t = threading.Thread(
                        target=self._writer_main,
                        name=f"{THREAD_NAME_PREFIX}-writer", daemon=True)
                    self._wthread = t
                    t.start()
                self._wcv.notify_all()
        else:
            self.wait()                  # FIFO after any queued writes
            self._run_job(job)

    def _pending_steps(self):
        with self._wcv:
            steps = {j["step"] for j in self._wq}
            if self._winflight is not None:
                steps.add(self._winflight["step"])
            return steps

    def _raise_write_failure_locked(self):
        if self._write_failure is not None:
            err, self._write_failure = self._write_failure, None
            raise err

    def _raise_write_failure(self):
        with self._wcv:
            self._raise_write_failure_locked()

    def _writer_main(self):
        while True:
            with self._wcv:
                if not self._wq:
                    self._wcv.wait(timeout=self._writer_linger_s)
                    if not self._wq:
                        self._wthread = None
                        self._wcv.notify_all()
                        return
                job = self._wq.pop(0)
                self._winflight = job
                self._wcv.notify_all()   # unblock a bounded producer
            try:
                self._run_job(job)
            except BaseException as e:  # noqa: BLE001 — held, re-raised
                # from the next save()/wait() on the caller's thread;
                # queued jobs are dropped with their on_fail (a delta
                # behind a failed commit has no durable parent)
                logger.error("async checkpoint write for ckpt-%s failed: "
                             "%s: %s", job["step"], type(e).__name__, e)
                with self._wcv:
                    self._write_failure = e
                    dropped = list(self._wq)
                    self._wq.clear()
                    self._winflight = None
                    self._wthread = None
                    self._wcv.notify_all()
                for dj in dropped:
                    self._safe_call(dj.get("on_fail"), e)
                return
            with self._wcv:
                self._winflight = None
                self._wcv.notify_all()

    @staticmethod
    def _safe_call(fn, *args):
        if fn is None:
            return
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — a callback must never mask
            logger.exception("checkpoint commit callback failed")

    def _run_job(self, job):
        t0 = time.perf_counter()
        try:
            info = self._write(job["step"], job["snap"], job["nonce"],
                               job["kind"])
        except BaseException as e:  # noqa: BLE001
            if self._proc()[1] == 1:
                with self._chain_lock:
                    self._planned_alive = False
                    self._planned_len = 0
            self._safe_call(job.get("on_fail"), e)
            raise
        info["ms"] = (time.perf_counter() - t0) * 1e3
        self.commits.append(info)
        self._emit_commit(info)
        self._safe_call(job.get("on_commit"), info)
        return info

    @staticmethod
    def _emit_commit(info):
        obs.observe_hist("checkpoint/commit_ms", info["ms"])
        if info["kind"] == "delta":
            obs.inc_counter("checkpoint/delta_bytes", info["bytes"])
            obs.inc_counter("checkpoint/delta_rows", info["rows"])
        elif info.get("rebase"):
            obs.inc_counter("checkpoint/rebase_total")
        obs.emit_event("ckpt", event="commit", step=info["step"],
                       commit_kind=info["kind"], bytes=info["bytes"],
                       rows=info["rows"], ms=round(info["ms"], 3),
                       chain_len=info.get("chain_len", 0),
                       rebase=bool(info.get("rebase")))

    def _begin_attempt(self, step: int) -> str:
        """On the calling thread: clear what a crashed earlier save left
        at this step and agree on the attempt's nonce (the only place
        the processes synchronize; the writer coordinates through
        nonce-matched files)."""
        proc, nprocs = self._proc()
        d = os.path.join(self.root, f"ckpt-{step}.tmp")
        if nprocs == 1:
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            return os.urandom(8).hex()
        self._sync(f"ckpt-{step}-begin")
        if proc == 0:
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            with open(os.path.join(d, "attempt.json"), "w") as f:
                json.dump({"nonce": os.urandom(8).hex()}, f)
        self._sync(f"ckpt-{step}-attempt")
        with open(os.path.join(d, "attempt.json")) as f:
            return json.load(f)["nonce"]

    def _fire_fault(self, site: str, path: Optional[str]):
        """The per-file fault site: ``ckpt.write`` (full commits) or
        ``ckpt.delta``.  ``truncate`` tears the file after its md5 was
        recorded; ``kill`` (``ckpt.delta``) SIGKILLs the process
        mid-chain; the generic actions raise."""
        if not _fi.ENABLED:
            return
        action = _fi.check(site)
        if action is None:
            return
        if action == "truncate" and path is not None:
            with open(path, "r+b") as fh:
                fh.truncate(max(os.path.getsize(path) // 2, 1))
        elif action == "kill" and site == "ckpt.delta":
            os.kill(os.getpid(), signal.SIGKILL)
        else:
            _fi.raise_for(action, site)

    def _write_piece(self, d, fn, arr, site):
        path = os.path.join(d, fn)
        np.save(path, arr)
        md5 = _file_md5(path)
        self._fire_fault(site, path)
        _fsync_file(path)
        return md5, os.path.getsize(path)

    def _write(self, step: int, snap, nonce: str, kind: str = "full"):
        proc, nprocs = self._proc()
        d = os.path.join(self.root, f"ckpt-{step}.tmp")
        final = os.path.join(self.root, f"ckpt-{step}")
        delta = kind == "delta"
        site = "ckpt.delta" if delta else "ckpt.write"
        parent = None
        if delta:
            with self._chain_lock:
                parent = self._committed
            if parent is None:
                raise DeltaChainError("delta commit with no committed "
                                      "parent tip")
            # before any bytes land: a delta's sparse shard layout must
            # be its parent's (same tables, same shard count), since the
            # merge by id cannot tell which rows of another layout live
            pg = {n for n in parent["vars"] if _sparse_group(n)}
            cg = {n for n in snap if _sparse_group(n)}
            if pg != cg:
                raise DeltaChainError(
                    f"sparse layout changed vs parent commit "
                    f"(parent-only: {sorted(pg - cg)[:4]}, "
                    f"new: {sorted(cg - pg)[:4]}); commit a full rebase")
        cb = self.chunk_bytes
        bytes_written = 0
        sparse_rows = 0
        manifest = {}
        for n, (shape, dtype, pieces) in snap.items():
            base = n.replace("/", "__")
            sparse = _sparse_group(n) is not None
            mode = "sparse" if sparse else (
                "chunks" if (delta and nprocs == 1) else "replace")
            pent = parent["vars"].get(n) if parent is not None else None
            diffable = (
                mode == "chunks" and pent is not None
                and pent.get("shape") == list(shape)
                and pent.get("dtype") == dtype
                and int(pent.get("chunk_bytes", 0) or 0) == cb
                and len(pent.get("shards", [])) == len(pieces))
            shards = []
            for k, (idx, arr) in enumerate(pieces):
                if diffable:
                    entry = self._write_patch(d, f"{base}.p{proc}s{k}.patch",
                                              arr, idx, pent["shards"][k],
                                              cb, site)
                    if entry is not None:
                        if entry["patch"] is not None:
                            bytes_written += entry.pop("_bytes")
                        shards.append(entry)
                        continue
                # a full piece (full commits; in a delta, a var it cannot
                # diff: new, or of another shape or layout)
                fn = f"{base}.p{proc}s{k}.npy"
                md5, size = self._write_piece(d, fn, arr, site)
                entry = {"file": fn, "md5": md5, "index": idx,
                         "shard_shape": list(arr.shape)}
                if nprocs == 1 and not sparse:
                    entry["chunks"] = _chunk_hashes(arr.tobytes(), cb)
                bytes_written += size
                if sparse and n.endswith("/ids"):
                    sparse_rows += int(arr.size)
                shards.append(entry)
            manifest[n] = {"shape": list(shape), "dtype": dtype,
                           "shards": shards, "mode": mode}
            if nprocs == 1 and not sparse:
                manifest[n]["chunk_bytes"] = cb
        mpath = os.path.join(d, f"shards-{proc}.json")
        with open(mpath, "w") as f:
            json.dump({"nonce": nonce, "vars": manifest}, f)
        _fsync_file(mpath)
        if nprocs > 1 and proc == 0:
            def _all_manifests_fresh():
                for p in range(nprocs):
                    path = os.path.join(d, f"shards-{p}.json")
                    try:
                        with open(path) as f:
                            if json.load(f).get("nonce") != nonce:
                                return False
                    except (OSError, json.JSONDecodeError):
                        return False
                return True
            self._wait_for(_all_manifests_fresh,
                           f"ckpt-{step} shard manifests")
        meta = None
        rebase = False
        if proc == 0:
            merged = {}
            for p in range(nprocs):
                with open(os.path.join(d, f"shards-{p}.json")) as f:
                    part = json.load(f)["vars"]
                for n, info in part.items():
                    if n not in merged:
                        merged[n] = {k: v for k, v in info.items()
                                     if k != "shards"}
                        merged[n]["shards"] = []
                    merged[n]["shards"].extend(info["shards"])
            meta = {"step": step, "timestamp": time.time(),
                    "format": "sharded-v1", "nonce": nonce, "vars": merged,
                    "kind": kind}
            if nprocs == 1:
                prev = parent
                if not delta:
                    with self._chain_lock:
                        prev = self._committed
                rebase = (not delta and prev is not None
                          and int(prev.get("chain_len", 0)) > 0)
                if delta:
                    meta["parent"] = parent["content_hash"]
                    meta["chain_len"] = int(parent.get("chain_len", 0)) + 1
                    meta["base_bytes"] = int(parent.get("base_bytes", 0))
                    meta["chain_bytes"] = \
                        int(parent.get("chain_bytes", 0)) + bytes_written
                else:
                    meta["parent"] = None
                    meta["chain_len"] = 0
                    meta["base_bytes"] = bytes_written
                    meta["chain_bytes"] = 0
                meta["delta_bytes"] = bytes_written
                meta["content_hash"] = _meta_content_hash(meta)
            # meta.json written last: the commit point
            meta_path = os.path.join(d, "meta.json")
            with open(meta_path, "w") as f:
                json.dump(meta, f)
            _fsync_file(meta_path)
            _fsync_dir(d)
            if os.path.exists(final):
                # a re-save of the same step (emergency over periodic):
                # shelve the old copy (".tmp" keeps it out of all_steps),
                # land the new one, drop the shelf; never no copy on disk
                prev_dir = final + ".prev.tmp"
                shutil.rmtree(prev_dir, ignore_errors=True)
                os.rename(final, prev_dir)
                os.rename(d, final)
                shutil.rmtree(prev_dir, ignore_errors=True)
            else:
                os.rename(d, final)
            _fsync_dir(self.root)
            if nprocs == 1:
                with self._chain_lock:
                    self._committed = meta
            self._gc()
        elif nprocs > 1:
            def _committed():
                try:
                    with open(os.path.join(final, "meta.json")) as f:
                        return json.load(f).get("nonce") == nonce
                except (OSError, json.JSONDecodeError):
                    return False
            self._wait_for(_committed, f"ckpt-{step} commit")
        return {"step": step, "kind": kind, "bytes": bytes_written,
                "rows": sparse_rows, "rebase": rebase,
                "chain_len": 0 if meta is None
                else int(meta.get("chain_len", 0)),
                "content_hash": None if meta is None
                else meta.get("content_hash")}

    def _write_patch(self, d, fn, arr, idx, pe, cb, site):
        """The manifest entry of a piece diffed against its parent entry
        ``pe``: no file when no chunk changed, else a ``.patch`` of the
        changed chunks.  None when the piece cannot be diffed."""
        if pe.get("index") != idx or pe.get("chunks") is None:
            return None
        raw = arr.tobytes()
        cur = _chunk_hashes(raw, cb)
        old = pe["chunks"]
        if len(cur) != len(old):
            return None
        changed = [i for i, (a, b) in enumerate(zip(old, cur)) if a != b]
        entry = {"index": idx, "shard_shape": list(arr.shape),
                 "chunks": cur, "patch": None}
        if not changed:
            return entry
        path = os.path.join(d, fn)
        with open(path, "wb") as fh:
            for ci in changed:
                fh.write(raw[ci * cb:(ci + 1) * cb])
        entry["patch"] = {"file": fn, "md5": _file_md5(path),
                          "changed": changed}
        self._fire_fault(site, path)
        _fsync_file(path)
        entry["_bytes"] = os.path.getsize(path)
        return entry

    def _wait_for(self, cond, what, timeout_s: Optional[float] = None,
                  poll_s: float = 0.05):
        timeout_s = self.barrier_timeout_s if timeout_s is None \
            else timeout_s
        deadline = time.time() + timeout_s
        while not cond():
            if time.time() > deadline:
                raise CheckpointTimeoutError(what, timeout_s)
            time.sleep(poll_s)

    def wait(self):
        """The durability barrier: block until every queued or in-flight
        write has committed; re-raise a write failure on this thread."""
        with self._wcv:
            while (self._wq or self._winflight is not None) \
                    and self._write_failure is None:
                self._wcv.wait()
            self._raise_write_failure_locked()

    # -- retention -----------------------------------------------------------
    def _read_meta(self, d) -> Optional[dict]:
        try:
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None

    def _commit_index(self) -> Dict[str, Tuple[int, str, dict]]:
        """content_hash -> (step, dir, meta) over every durable commit
        dir (committed and orphaned shelves)."""
        idx: Dict[str, Tuple[int, str, dict]] = {}
        for s in self.all_steps():
            for d in self._candidate_dirs(s):
                meta = self._read_meta(d)
                if meta is None:
                    continue
                h = meta.get("content_hash")
                if h and h not in idx:
                    idx[h] = (s, d, meta)
        return idx

    def _gc(self):
        steps = sorted(self.all_steps())
        if len(steps) > self.max_to_keep:
            keep = set(steps[-self.max_to_keep:])
            # a kept delta needs its ancestors: pin every base and delta
            # its chain replays through
            idx = self._commit_index()
            metas = {}
            for s in steps:
                for d in self._candidate_dirs(s):
                    m = self._read_meta(d)
                    if m is not None:
                        metas.setdefault(s, m)
            for s in sorted(keep):
                m = metas.get(s)
                hops = 0
                while (m is not None and m.get("kind") == "delta"
                        and m.get("parent") and hops < 10000):
                    got = idx.get(m["parent"])
                    if got is None:
                        break
                    ps, _pd, m = got
                    keep.add(ps)
                    hops += 1
            for s in steps:
                if s in keep:
                    continue
                shutil.rmtree(os.path.join(self.root, f"ckpt-{s}"),
                              ignore_errors=True)
                shutil.rmtree(
                    os.path.join(self.root, f"ckpt-{s}.prev.tmp"),
                    ignore_errors=True)
        # a shelf whose step's committed dir exists again is a leak
        for d in os.listdir(self.root):
            if d.endswith(".prev.tmp") and os.path.exists(
                    os.path.join(self.root, d[:-len(".prev.tmp")])):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self):
        out = set()
        for d in os.listdir(self.root):
            if not d.startswith("ckpt-"):
                continue
            # a committed dir, or a re-commit shelf orphaned by a crash
            # between the shelve renames (its data is intact)
            if d.endswith(".prev.tmp"):
                name = d[:-len(".prev.tmp")]
            elif d.endswith(".tmp"):
                continue
            else:
                name = d
            if os.path.exists(os.path.join(self.root, d, "meta.json")):
                out.add(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                scope: Optional[Scope] = None, verify: bool = True) -> int:
        """Load the newest (or the given) commit into ``scope``; returns
        its step.  A corrupt commit (md5 mismatch, a truncated file, a
        garbled meta, a broken delta chain) is skipped for the one
        before it; none intact raises ``FileNotFoundError``."""
        scope = global_scope() if scope is None else scope
        t0 = time.perf_counter()
        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        index = None
        for s, d in ((s, d) for s in candidates
                     for d in self._candidate_dirs(s)):
            try:
                with open(os.path.join(d, "meta.json")) as f:
                    meta = json.load(f)
                for n, info in meta["vars"].items():
                    if len(info["shards"]) > 1:
                        raise NotImplementedError(
                            f"checkpoint var {n!r} is stored in "
                            f"{len(info['shards'])} pieces (a sharded "
                            f"run's checkpoint); restoring it is not "
                            f"ported yet (ROADMAP Queue A item 7)")
                if meta.get("kind", "full") == "delta":
                    if index is None:
                        index = self._commit_index()
                    chain = self._resolve_chain(meta, d, index)
                    if verify:
                        for cd, cm in chain:
                            self._verify_commit(cd, cm)
                    arrays = self._replay_chain(chain, verify)
                else:
                    if verify:
                        self._verify_commit(d, meta)
                    arrays = {n: self._assemble(d, info)
                              for n, info in meta["vars"].items()}
            except NotImplementedError:
                raise
            except Exception as e:  # noqa: BLE001 — every corruption mode
                # falls back to the previous commit, loudly
                logger.warning(
                    "checkpoint ckpt-%s is corrupt/unreadable (%s: %s); "
                    "falling back to the previous checkpoint", s,
                    type(e).__name__, e)
                obs.inc_counter("fault/checkpoint_fallbacks")
                obs.emit_event("fault", event="checkpoint_fallback",
                               step=s, error=f"{type(e).__name__}: {e}")
                continue
            # intact: place it (a placement error is not corruption)
            loaded = {n: self._place(scope, n, arr,
                                     meta["vars"][n]["dtype"])
                      for n, arr in arrays.items()}
            for n, t in loaded.items():
                scope.set(n, t)
            self._adopt_tip(meta)
            self.last_restore_ms = (time.perf_counter() - t0) * 1e3
            return s
        raise FileNotFoundError(f"no valid checkpoint under {self.root}")

    def _verify_commit(self, d, meta):
        """Every referenced file's md5, and the content hash where the
        commit has one."""
        if meta.get("content_hash") and \
                _meta_content_hash(meta) != meta["content_hash"]:
            raise IOError(f"content-hash mismatch for {d}")
        for n, info in meta["vars"].items():
            for sh in info["shards"]:
                if sh.get("file"):
                    if _file_md5(os.path.join(d, sh["file"])) != sh["md5"]:
                        raise IOError(f"md5 mismatch for {n}")
                patch = sh.get("patch")
                if patch:
                    path = os.path.join(d, patch["file"])
                    if _file_md5(path) != patch["md5"]:
                        raise IOError(f"patch md5 mismatch for {n}")

    def _resolve_chain(self, tip_meta, tip_dir, index):
        """[(dir, meta)] from the base to the tip; raises when a parent
        link is missing (collected, corrupt, dangling)."""
        chain = [(tip_dir, tip_meta)]
        m = tip_meta
        while m.get("kind", "full") == "delta":
            p = m.get("parent")
            if not p or p not in index:
                raise IOError(
                    f"delta chain broken at ckpt-{m.get('step')}: parent "
                    f"{str(p)[:12]}... not found")
            _s, d, m = index[p]
            chain.append((d, m))
            if len(chain) > 10000:
                raise IOError("delta chain too long (cycle?)")
        chain.reverse()
        return chain

    def _assemble(self, d, info) -> np.ndarray:
        """One commit's host copy of a var (in its storage dtype)."""
        sh = info["shards"][0]
        arr = _as_storage(np.load(os.path.join(d, sh["file"])),
                          info["dtype"])
        return arr.reshape(info["shape"])

    def _replay_chunked(self, chain, name, tip_info, verify):
        """A chunk-diffed var: the newest full file of its piece, then
        the changed chunks patched forward; the bytes must hash to the
        tip's chunk table."""
        dtype = _storage_dtype(tip_info["dtype"])
        tent = tip_info["shards"][0]
        base_ci = None
        for ci in range(len(chain) - 1, -1, -1):
            vi = chain[ci][1]["vars"].get(name)
            if vi is None or not vi["shards"]:
                break
            if vi["shards"][0].get("file"):
                base_ci = ci
                break
        if base_ci is None:
            raise IOError(f"chunk chain for {name!r} has no base")
        e0 = chain[base_ci][1]["vars"][name]["shards"][0]
        arr0 = _as_storage(
            np.load(os.path.join(chain[base_ci][0], e0["file"])),
            tip_info["dtype"])
        raw = bytearray(arr0.tobytes())
        for ci in range(base_ci + 1, len(chain)):
            vi = chain[ci][1]["vars"][name]
            patch = vi["shards"][0].get("patch")
            if not patch:
                continue
            cbi = int(vi.get("chunk_bytes", DEFAULT_CHUNK_BYTES))
            with open(os.path.join(chain[ci][0], patch["file"]), "rb") as f:
                data = f.read()
            off = 0
            for cidx in patch["changed"]:
                lo = cidx * cbi
                hi = min(lo + cbi, len(raw))
                raw[lo:hi] = data[off:off + (hi - lo)]
                off += hi - lo
        if verify and tent.get("chunks") is not None:
            cbt = int(tip_info.get("chunk_bytes", DEFAULT_CHUNK_BYTES))
            if _chunk_hashes(bytes(raw), cbt) != tent["chunks"]:
                raise IOError(f"replayed chunks for {name!r} do not match "
                              f"the tip's chunk table")
        return np.frombuffer(raw, dtype=dtype).reshape(tip_info["shape"])

    @staticmethod
    def _merge_sparse_group(gp, basemap, deltamap, members):
        """One sparse shard group merged: the sorted union of the ids,
        the delta's rows over the base's (what pushing those rows again
        would give), so a replay equals a full export."""
        ids_key = gp + "/ids"
        bids = np.asarray(basemap[ids_key], np.int64)
        dids = np.asarray(deltamap[ids_key], np.int64)
        uids = np.union1d(bids, dids)
        out = {ids_key: uids}
        for m in members:
            if m == ids_key:
                continue
            b, dl = basemap[m], deltamap[m]
            ref = b if (b.size or not dl.size) else dl
            res = np.empty((len(uids),) + ref.shape[1:], ref.dtype)
            if len(bids):
                res[np.searchsorted(uids, bids)] = b
            if len(dids):
                res[np.searchsorted(uids, dids)] = dl
            out[m] = res
        return out

    def _replay_chain(self, chain, verify) -> Dict[str, np.ndarray]:
        """The tip's state, base to tip, by the tip manifest's modes:
        sparse shard groups merged by id along the chain, chunk-diffed
        vars patched forward, the rest from the tip."""
        tip_vars = chain[-1][1]["vars"]
        groups: Dict[str, List[str]] = {}
        for n, info in tip_vars.items():
            grp = _sparse_group(n)
            if info.get("mode") == "sparse" and grp:
                groups.setdefault(grp[0], []).append(n)
        out: Dict[str, np.ndarray] = {}
        for gp, members in groups.items():
            merged = None
            for d, meta in chain:
                if any(m not in meta["vars"] for m in members):
                    continue           # the group starts later in the chain
                cur = {m: self._assemble(d, meta["vars"][m])
                       for m in members}
                merged = cur if merged is None else \
                    self._merge_sparse_group(gp, merged, cur, members)
            out.update(merged)
        for n, info in tip_vars.items():
            if n in out:
                continue
            if info.get("mode") == "chunks":
                out[n] = self._replay_chunked(chain, n, info, verify)
            else:
                out[n] = self._assemble(chain[-1][0], info)
        return out

    def _place(self, scope, name, arr: np.ndarray, dtype: str):
        """The var as a tensor in the dtype and on the device of the one
        the scope holds (in the file's dtype if the shapes differ), else
        in the file's dtype on the manager's device; a sparse table's
        var as the host array it is."""
        if name.startswith(_SPARSE_PREFIX):
            return np.array(arr)
        t = _to_tensor(arr, dtype)
        dest = scope.get(name) if scope.has(name) else None
        if isinstance(dest, torch.Tensor):
            if tuple(dest.shape) == tuple(t.shape):
                return t.to(device=dest.device, dtype=dest.dtype)
            return t.to(dest.device)
        return t.to(self.device if self.device is not None else "cuda")

    def _candidate_dirs(self, step: int):
        """The existing dirs that may hold ``step``'s data, preferred
        first: the committed dir, then a re-commit shelf left by a crash
        between the same-step renames."""
        final = os.path.join(self.root, f"ckpt-{step}")
        out = []
        if os.path.exists(os.path.join(final, "meta.json")):
            out.append(final)
        shelf = final + ".prev.tmp"
        if os.path.exists(os.path.join(shelf, "meta.json")):
            out.append(shelf)
        return out


def save_checkpoint(root, step, scope=None, **kw):
    CheckpointManager(root, **kw).save(step, scope, blocking=True)


def load_checkpoint(root, step=None, scope=None, device=None):
    return CheckpointManager(root, device=device).restore(step, scope)
