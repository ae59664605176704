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
  :func:`replay_launches`).

The disk layer, ``CachedStep`` and ``Executor.compile`` of the JAX module
are not ported.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import threading
import weakref
from typing import Dict

import torch

__all__ = ["environment_key", "cache_dir", "fingerprint_hex",
           "program_content_digest", "ExecCache",
           "CaptureStats", "stats", "register_launch_counter",
           "launch_counters", "capture_launches", "replay_launches"]


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
    uncaptured: steps run by the interpreter for a reason other than a
    warm-up, by reason (``cpu``, ``use_jit=False``).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = collections.Counter()
        self.uncaptured: Dict[str, int] = collections.Counter()

    def bump(self, counter: str, n: int = 1):
        with self._lock:
            self.counters[counter] += n

    def bump_uncaptured(self, reason: str, n: int = 1):
        with self._lock:
            self.uncaptured[reason] += n

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: self.counters.get(k, 0)
                   for k in ("captures", "replays", "warmups", "hits",
                             "misses", "evictions", "validations")}
            out["uncaptured"] = dict(self.uncaptured)
            return out

    def report(self) -> str:
        """StatSet-style text block of the counters."""
        snap = self.snapshot()
        unc = snap.pop("uncaptured")
        lines = ["======= CaptureStats ======="]
        lines += [f"  {k}: {v}" for k, v in snap.items()]
        lines += [f"  uncaptured[{k}]: {v}" for k, v in sorted(unc.items())]
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            self.counters.clear()
            self.uncaptured.clear()


_stats = CaptureStats()


def stats() -> CaptureStats:
    return _stats


# ---------------------------------------------------------------------------
# Launch counters of the kernel wrappers
# ---------------------------------------------------------------------------
_launch_counters: list = []


def register_launch_counter(counter: "collections.Counter"):
    """Register a Counter a kernel wrapper bumps where it launches (once,
    at the wrapper module's import); returns it."""
    if not any(c is counter for c in _launch_counters):
        _launch_counters.append(counter)
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
