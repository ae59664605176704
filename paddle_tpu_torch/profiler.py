"""Profiling and timing utilities (counterpart of
``paddle_tpu/profiler.py``).

Reference analogs: v1 ``Stat``/``REGISTER_TIMER`` per-layer timers
(utils/Stat.h:63,114,230 printed per log period) and fluid's
``cuda_profiler`` nvprof context manager (fluid/profiler.py:19-52).
Here: ``torch.profiler`` traces (CPU and, with a card, CUDA activity,
written as a Chrome trace) plus host-side step timers.

This module is the human-facing surface of the observability layer
(``paddle_tpu_torch.observability``): :func:`report` renders the merged
StatSet + capture stats + metrics view, :func:`metrics_snapshot` the
structured one.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict

import torch

_trace_lock = threading.Lock()
_trace_depth = 0
_session = None


@contextlib.contextmanager
def profiler(output_dir: str = os.path.join("build", "torch_trace"),
             state=None, sorted_key=None):
    """Trace the enclosed steps with ``torch.profiler`` (cuda_profiler
    analog); the trace is written to ``output_dir/trace.json`` (Chrome
    trace format) when the outermost scope exits.

    ``state`` and ``sorted_key`` are accepted for reference API
    compatibility (fluid/profiler.py took 'GPU'/'total' etc.) and are
    ignored: the trace holds host and device activity, and sorting
    belongs to the viewer.

    Reentrant: nested scopes are no-op inner scopes — one trace session
    spans the outermost ``with``; the last scope to exit stops it.
    """
    del state, sorted_key            # reference-compat, ignored (see doc)
    global _trace_depth, _session
    with _trace_lock:
        _trace_depth += 1
        outermost = _trace_depth == 1
    if outermost:
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            with _trace_lock:
                _session = prof
        except BaseException:
            with _trace_lock:
                _trace_depth -= 1
            raise
    try:
        yield
    finally:
        with _trace_lock:
            _trace_depth -= 1
            prof = _session if _trace_depth == 0 else None
            if prof is not None:
                _session = None
        if prof is not None:
            prof.stop()
            os.makedirs(output_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(output_dir, "trace.json"))


cuda_profiler = profiler  # reference-name alias


class Stat:
    """Accumulating named timer (utils/Stat.h StatSet analog).

    Thread-safe: pipeline worker threads and the run_pipelined staging
    thread time into the same instance as the dispatch thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._totals[name] += dt
                self._counts[name] += 1

    def report(self) -> str:
        with self._lock:
            totals = dict(self._totals)
            counts = dict(self._counts)
        lines = ["======= StatSet ======="]
        for name in sorted(totals, key=lambda n: -totals[n]):
            tot = totals[name]
            cnt = max(counts.get(name, 0), 1)
            lines.append(f"  {name}: total={tot*1e3:.2f}ms count={cnt} "
                         f"avg={tot/cnt*1e3:.3f}ms")
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            self._totals.clear()
            self._counts.clear()


_global_stat = Stat()


def global_stat() -> Stat:
    return _global_stat


@contextlib.contextmanager
def timer(name: str):
    """REGISTER_TIMER analog on the global StatSet."""
    with _global_stat.timer(name):
        yield


def compile_stats():
    """The captured-step counters (``core.compile_cache.stats()``):
    captures, replays, warm-ups, cache hits/misses/evictions and the
    interpreted steps by reason."""
    from .core import compile_cache
    return compile_cache.stats()


def compile_report() -> str:
    """Human-readable captured-step telemetry (StatSet-style report)."""
    return compile_stats().report()


def metrics_snapshot() -> dict:
    """Structured merged snapshot: registry metrics + capture counters +
    per-card memory (see observability.export.metrics_snapshot)."""
    from .observability import metrics_snapshot as _snap
    return _snap()


def report() -> str:
    """ONE merged human-readable view: host-side StatSet timers, capture
    telemetry and the observability metrics registry — the v1
    ``printAllStatus`` every ``log_period`` analog (the trainer emits
    this via observability.maybe_periodic_report)."""
    from . import observability
    return "\n".join([_global_stat.report(), compile_report(),
                      observability.report()])


class StepTimer:
    """Per-step wall-clock with warmup discard, for benchmarks."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._t = None
        self._step = 0

    def start(self):
        self._t = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t
        self._step += 1
        if self._step > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)
