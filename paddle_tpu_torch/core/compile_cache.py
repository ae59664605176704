"""Step cache of the executor: fingerprints, an LRU of captured steps,
and their counters.

Counterpart of the in-memory half of ``paddle_tpu/core/compile_cache.py``.
The JAX executor keys each compiled step variant by a content hash of
everything that determines the traced computation; here the cached thing
is a step captured as a CUDA graph (``core/executor.py``,
``_CapturedStep``), keyed the same way:

- :func:`program_content_digest`: a hash of the serialized Program,
  memoized per (program object, ``version``, ``random_seed``), so the
  JSON is written once per program mutation, not once a step;
- :func:`fingerprint_hex`: the stable string form of a key (a signature
  tuple: the digest, the feed signature, fetch names, state keys with
  their shapes and dtypes, the executor's configuration and the device),
  for a cache that outlives the process; the in-memory cache is keyed by
  the tuple itself;
- :class:`ExecCache`: key -> entry, an LRU bounded by ``max_entries``
  and by ``max_bytes`` (the bytes its entries are charged: a captured
  step's graph pool), whose entries also drop when every Program that
  used them has been garbage-collected (the dead-program sweep).  An
  evicted entry is closed, which releases its graph and the graph's
  memory pool;
- :class:`CaptureStats` (:func:`stats`): captures, replays, cache hits,
  misses and evictions, warm-up steps, and the steps run uncaptured by
  reason;
- :func:`register_launch_counter` / :func:`launch_counters`: the
  Counters that kernel wrappers bump where they launch.  A replayed graph
  calls no wrapper, so a captured step adds the deltas its capture saw to
  each registered counter once per replay (:func:`capture_launches`,
  :func:`replay_launches`);
- the disk layer (:func:`disk_load`, :func:`disk_store`,
  ``DISK_FORMAT``): with the ``cache_dir`` flag (env
  ``PADDLE_TPU_TORCH_CACHE_DIR``) set, ``Executor.compile`` keeps one
  ``<dir>/ptxc-<fingerprint>.pkl`` a key, written to a tmp file and
  renamed; a load checks the format and the fingerprint, and any failure
  is a miss (a corrupt entry also logs one warning);
- :class:`CachedStep` (a key's step built on purpose by
  ``Executor.compile``, not on a first call) and :class:`CompiledProgram`
  (the handle ``compile`` returns).

A CUDA graph cannot be serialized, so an entry does not hold the step
itself, as the JAX entry holds an XLA executable: it holds what the cold
start learned (its phase times, the capture's launches by kernel and
form, the K1 plans and flash ring depths the step took, the graph
pool's bytes and the step listing, each op with the route it took).  A
warm ``compile`` warms up and captures as a cold one does and reports
the entry's facts beside its own times: on an H100 a capture without
the interpreted warm-up was slower than the warm-up and capture it
replaced (PERF.md).  The nvcc builds persist in ``build/`` by content
hash (``ops/cuda_build.py``), so neither start compiles a kernel twice.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import logging
import os
import pickle
import tempfile
import threading
import weakref
from typing import Dict, List, Optional

import torch

__all__ = ["environment_key", "cache_dir", "fingerprint_hex",
           "program_content_digest", "ExecCache",
           "CaptureStats", "stats", "register_launch_counter",
           "launch_counters", "capture_launches", "replay_launches",
           "counter_deltas", "DISK_FORMAT", "disk_load",
           "disk_store", "CachedStep", "CompiledProgram"]

logger = logging.getLogger("paddle_tpu_torch")

DISK_FORMAT = 1                  # bump to invalidate every on-disk entry
_DISK_PREFIX = "ptxc-"


_env_key = None


def environment_key():
    """Process-environment component of every fingerprint: a captured
    step or a tuning record is valid only for the same torch, CUDA and
    port versions."""
    global _env_key
    if _env_key is None:
        from .. import __version__
        _env_key = (torch.__version__, str(torch.version.cuda), __version__)
    return _env_key


def cache_dir() -> str:
    """Active persistent-cache root ('' = off): the ``cache_dir`` flag,
    which ``PADDLE_TPU_TORCH_CACHE_DIR`` seeds.  The tuning store keeps
    its records under it."""
    from .. import flags
    return str(flags.get_flag("cache_dir") or "")


def fingerprint_hex(sig) -> str:
    """Stable hex digest of a structured signature tuple, which must repr
    deterministically (strings, ints, bools, nested tuples)."""
    payload = repr((sig, environment_key()))
    return hashlib.sha256(payload.encode()).hexdigest()


def program_content_digest(program) -> str:
    """Content hash of a serialized Program, memoized per version bump.

    The memo carries the program's ``id``: a ``clone`` (a deep copy) that
    is edited without a version bump recomputes instead of inheriting its
    source's digest."""
    key = (id(program), program.version, program.random_seed)
    cached = getattr(program, "_content_digest", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    payload = json.dumps(program.to_dict(), sort_keys=True,
                         separators=(",", ":"), default=repr)
    digest = hashlib.sha256(payload.encode()).hexdigest()
    program._content_digest = (key, digest)
    return digest


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------
class CaptureStats:
    """Counters of the captured-step path.

    counters:
      captures    — steps captured as a CUDA graph (each also replayed once)
      replays     — graph replays, one per step run on the captured path
      warmups     — steps run interpreted as a key's warm-up (the first
                    step of a new key on the card)
      hits/misses — ExecCache lookups
      evictions   — entries dropped by the LRU bound or the dead sweep
      validations — static verifier runs (``analysis.validate_program``;
                    the executor memoizes one per program version and
                    fetch list)
      disk_hits/disk_misses — persistent-entry lookups (``disk_load``)
      disk_stores — entries written (``disk_store``)
    uncaptured: steps run by the interpreter for a reason other than a
    warm-up, by reason (``cpu``, ``use_jit=False``).
    entries: per fingerprint, the phase times of the compile that built
    its step (:meth:`record_times`) and where they came from (``compile``
    or ``disk``).
    """

    COUNTERS = ("captures", "replays", "warmups", "hits", "misses",
                "evictions", "validations", "disk_hits", "disk_misses",
                "disk_stores")

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = collections.Counter()
        self.uncaptured: Dict[str, int] = collections.Counter()
        self.entries: Dict[str, dict] = {}

    def bump(self, counter: str, n: int = 1):
        with self._lock:
            self.counters[counter] += n

    def bump_uncaptured(self, reason: str, n: int = 1):
        with self._lock:
            self.uncaptured[reason] += n

    def record_times(self, fp: str, source: str, **times):
        """Phase seconds of the compile of key ``fp`` (``validate_s``,
        ``warmup_s``, ``capture_s``), from ``source``."""
        with self._lock:
            e = self.entries.setdefault(fp, {"times": {}, "source": None})
            e["times"].update({k: round(float(v), 6)
                               for k, v in times.items()})
            e["source"] = source

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: self.counters.get(k, 0) for k in self.COUNTERS}
            out["uncaptured"] = dict(self.uncaptured)
            return out

    def report(self) -> str:
        """StatSet-style text block of the counters."""
        snap = self.snapshot()
        unc = snap.pop("uncaptured")
        lines = ["======= CaptureStats ======="]
        lines += [f"  {k}: {v}" for k, v in snap.items()]
        lines += [f"  uncaptured[{k}]: {v}" for k, v in sorted(unc.items())]
        with self._lock:
            for fp, e in self.entries.items():
                t = " ".join(f"{k}={v * 1e3:.1f}ms"
                             for k, v in e["times"].items())
                lines.append(f"  [{fp[:12]}] source={e['source']} {t}")
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            self.counters.clear()
            self.uncaptured.clear()
            self.entries.clear()


_stats = CaptureStats()


def stats() -> CaptureStats:
    return _stats


# ---------------------------------------------------------------------------
# Launch counters of the kernel wrappers
# ---------------------------------------------------------------------------
_launch_counters: list = []
# id(counter) -> (name, kind) of the counters registered with a name
_counter_info: Dict[int, tuple] = {}
COUNTER_KINDS = ("launches", "detail")


def register_launch_counter(counter: "collections.Counter",
                            name: Optional[str] = None,
                            kind: str = "launches"):
    """Register a Counter a kernel wrapper bumps where it launches (once,
    at the wrapper module's import); returns it.

    ``name`` labels its deltas in a compiled step's entry.  ``kind``:
    ``launches`` (a kernel's launches: an op that moves it took the
    kernel route) or ``detail`` (the same launches by another key:
    dtype, plan, ring depth)."""
    if kind not in COUNTER_KINDS:
        raise ValueError(f"register_launch_counter: kind {kind!r} not in "
                         f"{COUNTER_KINDS}")
    if not any(c is counter for c in _launch_counters):
        _launch_counters.append(counter)
    if name is not None:
        _counter_info[id(counter)] = (str(name), kind)
    return counter


def launch_counters() -> tuple:
    """Every registered launch Counter."""
    return tuple(_launch_counters)


@contextlib.contextmanager
def capture_launches(deltas: list):
    """Around a CUDA-graph capture, in which the wrappers count launches
    that were only recorded: on exit every registered Counter is set back
    to what it held before, and ``deltas`` holds, one Counter each, what
    the capture counted, which :func:`replay_launches` adds once a
    replay."""
    counters = launch_counters()
    before = [collections.Counter(c) for c in counters]
    try:
        yield
    finally:
        deltas[:] = []
        for c, b in zip(counters, before):
            deltas.append(collections.Counter(c) - b)
            c.clear()
            c.update(b)


def replay_launches(deltas: list):
    """Count one replay of a graph whose capture counted ``deltas``."""
    for c, d in zip(launch_counters(), deltas):
        if d:
            c.update(d)


def counter_deltas(deltas: list, kinds=COUNTER_KINDS) -> Dict[str, dict]:
    """``{name: {str(key): n}}`` of the named counters of ``kinds`` among
    ``deltas`` (one Counter a registered counter, in registration order,
    as :func:`capture_launches` fills them); zero entries left out."""
    out: Dict[str, dict] = {}
    for c, d in zip(launch_counters(), deltas):
        info = _counter_info.get(id(c))
        if info is None or info[1] not in kinds:
            continue
        keys = {_key_str(k): int(n) for k, n in d.items() if n}
        if keys:
            out[info[0]] = keys
    return out


def _key_str(key) -> str:
    if isinstance(key, tuple):
        return "/".join(_key_str(k) for k in key)
    if isinstance(key, torch.dtype):
        return str(key).replace("torch.", "")
    return str(key)


# ---------------------------------------------------------------------------
# LRU of entries with a dead-program sweep
# ---------------------------------------------------------------------------
class _Entry:
    __slots__ = ("value", "prog_refs", "nbytes")

    def __init__(self, value, program):
        self.value = value
        self.prog_refs = [weakref.ref(program)]
        self.nbytes = 0

    def add_client(self, program):
        for r in self.prog_refs:
            if r() is program:
                return
        self.prog_refs = [r for r in self.prog_refs if r() is not None]
        self.prog_refs.append(weakref.ref(program))

    def dead(self) -> bool:
        return all(r() is None for r in self.prog_refs)


def _close(value):
    close = getattr(value, "close", None)
    if close is not None:
        close()


class ExecCache:
    """Key -> entry with an LRU bound and dead-entry sweeping.

    Each entry keeps weak references to every Program that used it, and
    the entry itself holds none, so when the last of them is collected
    the entry drops at the next ``put`` or ``sweep``.  ``max_entries``
    bounds the live entries; ``max_bytes`` (None: no bound) bounds the
    bytes charged to them (:meth:`charge`), least recently used first
    out, never the entry just charged.  A dropped entry is closed (its
    ``close()`` is called when it has one)."""

    def __init__(self, max_entries: int = 64, max_bytes=None):
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._od: "collections.OrderedDict[object, _Entry]" = \
            collections.OrderedDict()

    def __len__(self):
        return len(self._od)

    def __contains__(self, fp):
        return fp in self._od

    def values(self):
        return [e.value for e in self._od.values()]

    def get(self, fp, program=None):
        e = self._od.get(fp)
        if e is None:
            _stats.bump("misses")
            return None
        self._od.move_to_end(fp)
        if program is not None:
            e.add_client(program)
        _stats.bump("hits")
        return e.value

    def put(self, fp, value, program):
        self.sweep()
        old = self._od.pop(fp, None)
        if old is not None and old.value is not value:
            _close(old.value)
        self._od[fp] = _Entry(value, program)
        while len(self._od) > self.max_entries:
            _, e = self._od.popitem(last=False)
            self._evict(e)

    @property
    def nbytes(self) -> int:
        """The bytes charged to the live entries."""
        return sum(e.nbytes for e in self._od.values())

    def charge(self, fp, nbytes: int):
        """Charge ``nbytes`` to the entry of ``fp`` (which becomes the
        most recently used), then evict the least recently used others
        while the total exceeds ``max_bytes``."""
        e = self._od[fp]
        e.nbytes = int(nbytes)
        self._od.move_to_end(fp)
        while self.max_bytes is not None and len(self._od) > 1 and \
                self.nbytes > self.max_bytes:
            _, old = self._od.popitem(last=False)
            self._evict(old)

    def _evict(self, e: _Entry):
        _close(e.value)
        _stats.bump("evictions")

    def sweep(self):
        for fp in [fp for fp, e in self._od.items() if e.dead()]:
            self._evict(self._od.pop(fp))

    def clear(self):
        while self._od:
            _close(self._od.popitem()[1].value)


# ---------------------------------------------------------------------------
# Persistent on-disk layer
# ---------------------------------------------------------------------------
def _disk_path(dirpath: str, fp: str) -> str:
    return os.path.join(dirpath, f"{_DISK_PREFIX}{fp}.pkl")


def disk_load(fp: str) -> Optional[dict]:
    """The persisted entry of key ``fp`` (its hex fingerprint), or None.
    A missing file is a miss; so is any other failure (a corrupt or
    truncated file, a foreign format or fingerprint), which also logs one
    warning.  The fingerprint folds in the torch, CUDA and port versions,
    so a stale entry is never hit."""
    d = cache_dir()
    if not d:
        return None
    try:
        with open(_disk_path(d, fp), "rb") as f:
            payload = pickle.load(f)
        if not isinstance(payload, dict) or \
                payload.get("format") != DISK_FORMAT or \
                payload.get("fingerprint") != fp:
            raise ValueError("foreign format or fingerprint")
    except FileNotFoundError:
        _stats.bump("disk_misses")
        return None
    except Exception as e:
        logger.warning("compile cache: unreadable entry for %s... (%s: %s); "
                       "compiling it afresh", fp[:12], type(e).__name__, e)
        _stats.bump("disk_misses")
        return None
    _stats.bump("disk_hits")
    return payload


def disk_store(fp: str, payload: dict):
    """Persist ``payload`` as the entry of key ``fp``: written to a tmp
    file in the cache directory and renamed, so a concurrent reader never
    sees a truncated one.  A failure logs a warning and stores nothing."""
    d = cache_dir()
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        payload = dict(payload, format=DISK_FORMAT, fingerprint=fp)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=_DISK_PREFIX, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, _disk_path(d, fp))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _stats.bump("disk_stores")
    except Exception as e:
        logger.warning("compile cache: could not persist %s... (%s: %s)",
                       fp[:12], type(e).__name__, e)


# ---------------------------------------------------------------------------
# A step built ahead of its first call, and its handle
# ---------------------------------------------------------------------------
class CachedStep:
    """The step of ONE key built on purpose by ``Executor.compile``, not
    on a first call: on a card, the key's captured step (``captured``,
    the executor's ``_CapturedStep`` in its cache), and on both devices
    the facts an entry on disk holds (``facts``): ``times`` (the phase
    seconds: ``validate_s``, ``warmup_s``, ``capture_s``; on a warm
    start the cold start's times under ``cold_times``), ``launches`` and
    ``detail`` (the capture's launch deltas by kernel and form, and by
    plan and ring depth), ``pool_bytes`` (its graph pool),
    ``capture_peak_bytes`` (the bytes the allocator held as the capture
    began, its static buffers and the pool: a bound on its peak, read
    without resetting the card's peak statistics) and ``listing`` (its
    ops in order, each with the route it took: ``kernel`` where it moved
    a kernel's launch counter, else ``other``).  ``source``:
    ``compile`` (this process built it cold) or ``disk`` (an entry on
    disk made it a warm start)."""

    def __init__(self, fingerprint: str, facts: dict, captured=None,
                 source: str = "compile"):
        self._fp = fingerprint
        self.facts = dict(facts)
        self.captured = captured
        self.source = source

    @property
    def fingerprint(self) -> str:
        return self._fp

    @property
    def times(self) -> Dict[str, float]:
        return dict(self.facts.get("times") or {})

    @property
    def listing(self) -> List[dict]:
        return list(self.facts.get("listing") or [])

    def stablehlo(self) -> str:
        """The step listing as text, one op a line: its index, type, the
        route it took and the kernel launches it made."""
        lines = []
        for r in self.listing:
            kern = ", ".join(f"{name} {keys}" for name, keys in
                             sorted((r.get("launches") or {}).items()))
            lines.append(f"{r['index']:4d} {r['op']:<24} {r['route']:<8} "
                         f"{kern}".rstrip())
        return "\n".join(lines)


class CompiledProgram:
    """Handle returned by ``Executor.compile``: a step built ahead of its
    first call and installed in the executor's cache, so the matching
    ``Executor.run`` (or ``run_steps`` when ``num_steps`` is given)
    replays it with no warm-up and no capture.  ``run(...)`` delegates
    with the bound fetch list."""

    def __init__(self, executor, program, fingerprint: str,
                 step: CachedStep, fetch_names, state_keys, num_steps=None,
                 feeds_stacked=False, is_test=False):
        self._executor = executor
        self.program = program
        self.fingerprint = fingerprint
        self._step = step
        self.fetch_names = list(fetch_names)
        self.state_keys = list(state_keys)
        self.num_steps = num_steps
        self.feeds_stacked = feeds_stacked
        self.is_test = is_test

    @property
    def executor(self):
        """The executor this step is installed in (the serving runtime
        dispatches other bucket sizes through it, sharing its cache)."""
        return self._executor

    @property
    def step(self) -> CachedStep:
        return self._step

    @property
    def compile_times(self) -> Dict[str, float]:
        return self._step.times

    def stablehlo(self) -> str:
        """The JAX name, kept for API parity: here the port's step listing
        (:meth:`CachedStep.stablehlo`), not StableHLO."""
        return self._step.stablehlo()

    def run(self, feed=None, scope=None, return_numpy=True):
        if self.num_steps is not None:
            return self._executor.run_steps(
                self.num_steps, self.program, feed=feed,
                fetch_list=self.fetch_names, scope=scope,
                return_numpy=return_numpy, is_test=self.is_test,
                feeds_stacked=self.feeds_stacked)
        return self._executor.run(
            self.program, feed=feed, fetch_list=self.fetch_names,
            scope=scope, return_numpy=return_numpy, is_test=self.is_test)

    def __repr__(self):
        return (f"CompiledProgram(fingerprint={self.fingerprint[:12]}..., "
                f"fetches={self.fetch_names}, num_steps={self.num_steps})")
