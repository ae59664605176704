"""Runtime lock-order watchdog (counterpart of
``paddle_tpu/testing/lockwatch.py``).

An opt-in instrumented Lock/RLock/Condition records the process-wide
acquisition-order graph by lock **class** (the name passed to the
factory, lockdep-style: ten per-connection locks of one kind are one
node) and, at every acquire, checks the would-be edge against the graph
**before blocking**.  A cycle therefore surfaces as a deterministic
:class:`LockOrderViolation` naming both lock classes and both first-seen
acquisition stacks, instead of the interleaving-dependent hang a real
inversion produces.  A held-too-long watchdog feeds the
``concurrency/*`` metrics on release.

The ``PADDLE_TPU_LOCKWATCH`` environment variable is read once at
import; when it is off, :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition` return **plain** ``threading`` primitives: the
same types, no work per acquisition.  Enable it for a run::

    PADDLE_TPU_LOCKWATCH=1 python -m pytest tests/test_torch_decode.py

Knobs:

* ``PADDLE_TPU_LOCKWATCH`` — truthy enables instrumentation.
* ``PADDLE_TPU_LOCKWATCH_HOLD_MS`` — held-too-long threshold for the
  ``concurrency/long_holds`` counter (default 1000).

Deliberately not wrapped: the metrics registry's own lock (the watchdog
writes metrics; wrapping it would recurse) and the capture-stats lock
(a leaf lock the watchdog itself may reach).
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ENABLED", "enabled", "make_lock", "make_rlock", "make_condition",
    "LockOrderViolation", "graph", "violations", "reset",
    "hold_threshold_ms",
]


def _env_on(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


#: resolved ONCE at import — the off path must stay compiled-out cheap,
#: so per-call env reads are off the table (the contract of faultinject)
ENABLED = _env_on("PADDLE_TPU_LOCKWATCH")

_DEFAULT_HOLD_MS = 1000.0


def enabled() -> bool:
    """Is lockwatch instrumentation active in this process?"""
    return ENABLED


def hold_threshold_ms() -> float:
    try:
        return float(os.environ.get("PADDLE_TPU_LOCKWATCH_HOLD_MS",
                                    _DEFAULT_HOLD_MS))
    except ValueError:
        return _DEFAULT_HOLD_MS


class LockOrderViolation(RuntimeError):
    """A lock acquisition would create an ordering cycle.

    Raised by the acquiring thread BEFORE it blocks, so the process
    reports the inversion deterministically instead of deadlocking when
    the interleaving happens to interleave.  Carries both lock-class
    names and both acquisition stacks: the current one (this thread,
    ``holding`` -> ``acquiring``) and the first-seen stack that recorded
    the reverse edge (``acquiring`` -> ... -> ``holding``).
    """

    def __init__(self, acquiring: str, holding: str,
                 current_stack: str, reverse_stack: str,
                 path: Tuple[str, ...]):
        self.acquiring = acquiring
        self.holding = holding
        self.current_stack = current_stack
        self.reverse_stack = reverse_stack
        self.path = path
        super().__init__(self.report())

    def report(self) -> str:
        chain = " -> ".join(self.path)
        return (
            f"lock-order violation: acquiring {self.acquiring!r} while "
            f"holding {self.holding!r}, but the acquisition graph "
            f"already orders {chain} — two threads taking these locks "
            f"in opposite order deadlock.\n"
            f"--- this thread (holds {self.holding!r}, wants "
            f"{self.acquiring!r}):\n{self.current_stack}"
            f"--- first-seen reverse ordering ({self.acquiring!r} "
            f"before {self.holding!r}):\n{self.reverse_stack}")


# ---------------------------------------------------------------------------
# Process-wide state (only touched when ENABLED)
# ---------------------------------------------------------------------------
_glock = threading.Lock()        # guards _edges/_violations (leaf lock)
#: lock-class edge -> first-seen acquisition stack: _edges[a][b] is set
#: when some thread acquired class b while holding class a
_edges: Dict[str, Dict[str, str]] = {}
_violations: List[LockOrderViolation] = []
_tls = threading.local()


def _held() -> List[Tuple[str, int, float]]:
    """This thread's hold stack: (class name, instance id, t_acquire)."""
    try:
        return _tls.held
    except AttributeError:
        _tls.held = []
        return _tls.held


def _reachable(src: str, dst: str) -> Optional[Tuple[str, ...]]:
    """Path src -> ... -> dst in the edge graph, or None.  Caller holds
    ``_glock``."""
    stack = [(src, (src,))]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, {}):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def _metrics():
    # local import: lockwatch must not pull the observability package
    # into processes that never enable it
    from ..observability import metrics as _m
    return _m


def _pre_acquire(name: str, inst: int, reentrant: bool):
    """Order check + edge recording; runs BEFORE blocking on the lock."""
    held = _held()
    if any(h_inst == inst for (_n, h_inst, _t) in held):
        if reentrant:
            return                      # RLock re-entry: no new ordering
        raise LockOrderViolation(
            name, name, "".join(traceback.format_stack(limit=16)),
            "(same thread, same lock instance)", (name, name))
    held_names = [n for (n, _i, _t) in held
                  if n != name]         # same class doesn't order itself
    if not held_names:
        return
    with _glock:
        for h in held_names:
            path = _reachable(name, h)
            if path is not None:
                reverse = _edges.get(path[0], {}).get(path[1], "<?>")
                v = LockOrderViolation(
                    name, h,
                    "".join(traceback.format_stack(limit=16)),
                    reverse, path + (name,))
                _violations.append(v)
                try:
                    _metrics().inc_counter(
                        "concurrency/order_violations")
                except ImportError:
                    pass        # interpreter shutdown mid-teardown
                raise v
        new_edge = False
        for h in held_names:
            d = _edges.setdefault(h, {})
            if name not in d:
                d[name] = "".join(traceback.format_stack(limit=16))
                new_edge = True
        if new_edge:
            try:
                _metrics().set_gauge(
                    "concurrency/order_edges",
                    sum(len(d) for d in _edges.values()))
            except ImportError:
                pass            # interpreter shutdown mid-teardown


def _post_acquire(name: str, inst: int):
    _held().append((name, inst, time.monotonic()))


def _pre_release(name: str, inst: int):
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][1] == inst:
            _n, _i, t0 = held.pop(i)
            held_ms = (time.monotonic() - t0) * 1000.0
            try:
                m = _metrics()
                m.observe_hist("concurrency/lock_held_ms", held_ms)
                if held_ms >= hold_threshold_ms():
                    m.inc_counter("concurrency/long_holds")
            except ImportError:
                pass            # interpreter shutdown mid-teardown
            return


class _WatchedLock:
    """Instrumented mutex; context-manager and acquire/release compatible
    with ``threading.Lock`` / ``RLock``."""

    def __init__(self, name: str, reentrant: bool):
        self._name = name
        self._reentrant = reentrant
        self._raw = threading.RLock() if reentrant else threading.Lock()
        self._depth = 0          # RLock re-entry depth (owner-only write)

    # -- lock protocol ----------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        _pre_acquire(self._name, id(self), self._reentrant)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            if self._reentrant:
                self._depth += 1
                if self._depth == 1:
                    _post_acquire(self._name, id(self))
            else:
                _post_acquire(self._name, id(self))
        return ok

    def release(self):
        if self._reentrant:
            self._depth -= 1
            if self._depth == 0:
                _pre_release(self._name, id(self))
        else:
            _pre_release(self._name, id(self))
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._raw.locked() if hasattr(self._raw, "locked") \
            else self._depth > 0

    def __repr__(self):
        kind = "RLock" if self._reentrant else "Lock"
        return f"<lockwatch.{kind} {self._name!r}>"


class _WatchedCondition:
    """Condition bound to a watched lock: delegates the wait machinery to
    a real ``threading.Condition`` built on the RAW lock (so
    ``_is_owned``/``_release_save`` see a native primitive), while the
    hold bookkeeping goes through the watched wrapper.

    ``wait`` re-acquires WITHOUT the cycle re-check: the thread held this
    lock before waiting, so its ordering edges are already recorded, and
    re-checking after the wakeup would re-raise on edges the pre-wait
    acquire legitimately created.
    """

    def __init__(self, lock: _WatchedLock):
        self._wlock = lock
        self._cond = threading.Condition(lock._raw)

    # the lock protocol proxies through the watched lock
    def acquire(self, *a, **kw):
        return self._wlock.acquire(*a, **kw)

    def release(self):
        self._wlock.release()

    def __enter__(self):
        self._wlock.acquire()
        return self

    def __exit__(self, *exc):
        self._wlock.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        _pre_release(self._wlock._name, id(self._wlock))
        if self._wlock._reentrant:
            depth, self._wlock._depth = self._wlock._depth, 0
        try:
            return self._cond.wait(timeout)
        finally:
            if self._wlock._reentrant:
                self._wlock._depth = depth
            _post_acquire(self._wlock._name, id(self._wlock))

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # manual re-implementation so each park goes through wait()'s
        # hold bookkeeping
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __repr__(self):
        return f"<lockwatch.Condition on {self._wlock._name!r}>"


# ---------------------------------------------------------------------------
# Factories — THE api call sites use.  Off: plain threading primitives
# (type identity pinned by tests), zero bookkeeping ever allocated.
# ---------------------------------------------------------------------------
def make_lock(name: str):
    """A mutex named for ordering purposes; plain ``threading.Lock`` when
    lockwatch is off."""
    if not ENABLED:
        return threading.Lock()
    return _WatchedLock(name, reentrant=False)


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    if not ENABLED:
        return threading.RLock()
    return _WatchedLock(name, reentrant=True)


def make_condition(name: str, lock=None):
    """A condition variable on ``lock`` (or a fresh named lock).

    When lockwatch is on and ``lock`` is a watched lock, the condition
    shares its graph node; when off this is exactly
    ``threading.Condition(lock)``.
    """
    if not ENABLED:
        return threading.Condition(lock)
    if lock is None:
        lock = _WatchedLock(name, reentrant=False)
    if isinstance(lock, _WatchedLock):
        return _WatchedCondition(lock)
    # a raw lock slipped in (e.g. created before enabling): fall back to
    # the plain primitive rather than mis-track ownership
    return threading.Condition(lock)


# ---------------------------------------------------------------------------
# Introspection (tests, stats CLI)
# ---------------------------------------------------------------------------
def graph() -> Dict[str, Tuple[str, ...]]:
    """The current acquisition-order graph: {held: (acquired-after, ...)}."""
    with _glock:
        return {a: tuple(sorted(d)) for a, d in sorted(_edges.items())}


def violations() -> List[LockOrderViolation]:
    with _glock:
        return list(_violations)


def reset():
    """Clear the process-wide graph + violation list (tests only)."""
    with _glock:
        _edges.clear()
        _violations.clear()
