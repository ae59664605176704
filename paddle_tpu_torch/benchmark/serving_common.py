"""Deploy-artifact helpers of the inference benchmark (the port's own copy
of ``benchmark/serving_common.py:21-145``).

One model/manifest path for the deploy benchmarks:
``paddle_tpu_torch.benchmark.inference`` exports with
:func:`export_program` (its models) or :func:`export_mlp`, loads
through :func:`load_artifact` and makes wire feeds with
:func:`feeds_from_manifest`, so every caller follows one artifact
convention.
"""
from __future__ import annotations

import threading
import time

import numpy as np


def export_program(dirname, feed_specs, build, seed=0, device=None):
    """Build a model in fresh default programs (``build()`` returns its
    output vars), initialize it from ``seed`` on ``device`` (default: the
    card) and export it to ``dirname``.  Returns (dirname, export
    seconds)."""
    from .. import core
    from ..core.executor import Executor
    from ..export_model import export_compiled_model, resolve_place

    core.reset_default_programs()
    core.reset_global_scope()
    core.unique_name.reset()
    outs = build()
    core.default_startup_program().random_seed = seed
    Executor(resolve_place(device)).run(core.default_startup_program())
    t0 = time.perf_counter()
    export_compiled_model(dirname, feed_specs, outs, device=device)
    secs = time.perf_counter() - t0
    core.reset_default_programs()
    core.reset_global_scope()
    return dirname, secs


def export_mlp(dirname: str, in_dim: int = 784, hidden=(2048, 2048, 2048),
               classes: int = 10, seed: int = 0, device=None) -> str:
    """Export a dense classifier MLP as a symbolic-batch artifact (the
    serving benchmark's standard tenant) for ``device`` (default: the
    card)."""
    from .. import layers

    def build():
        h = layers.data("x", shape=[in_dim], dtype="float32")
        for width in hidden:
            h = layers.fc(h, size=width, act="relu")
        return [layers.fc(h, size=classes, act="softmax")]
    return export_program(dirname, {"x": ((-1, in_dim), "float32")}, build,
                          seed, device)[0]


def load_artifact(dirname: str, device=None):
    """(run, manifest) of an exported artifact: the binding the
    benchmarks measure through."""
    from ..export_model import load_compiled_model
    return load_compiled_model(dirname, device=device)


def feeds_from_manifest(manifest: dict, batch: int, rng,
                        int_high: int = 2):
    """A stacked feed dict from an artifact manifest's input specs: floats
    U(0, 1), ints U(0, int_high); a symbolic batch dim at ``batch``."""
    feeds = {}
    for name, spec in manifest["inputs"].items():
        shape = list(spec["shape"])
        if shape and (shape[0] is None or int(shape[0]) < 0):
            shape = [batch] + [int(d) for d in shape[1:]]
        else:
            shape = [int(d) for d in shape]
        dtype = np.dtype(spec["dtype"])
        if dtype.kind in "iu":
            feeds[name] = rng.randint(0, int_high, shape).astype(dtype)
        else:
            feeds[name] = rng.rand(*shape).astype(dtype)
    return feeds


def single_example(manifest: dict, rng, int_high: int = 2):
    """One request's feeds (no batch axis) from a manifest.  Every input
    must have a symbolic leading batch dim: a fixed-shape input has no
    batch axis to strip."""
    for name, spec in manifest["inputs"].items():
        shape = list(spec["shape"])
        if not shape or not (shape[0] is None or int(shape[0]) < 0):
            raise ValueError(
                f"artifact input {name!r} has fixed shape {shape}; "
                f"serving needs a symbolic batch dim (export with a "
                f"-1/None leading dim)")
    stacked = feeds_from_manifest(manifest, 1, rng, int_high=int_high)
    return {k: v[0] for k, v in stacked.items()}


def closed_loop(srv, example, *, workers: int, duration_s: float,
                timeout_s: float = 120.0, check=None):
    """Closed-loop load: ``workers`` threads issue back-to-back
    synchronous infers against a started server for ``duration_s``.
    ``check(outputs)``, when given, runs on every response and raises on
    a wrong one.  Returns ``(sorted_latencies_s, row)``; a worker's
    exception ends that worker and is counted in ``worker_errors``
    (``first_error`` keeps the first), and a run that served nothing
    raises."""
    lat, errors = [], []
    lock = threading.Lock()
    stop = time.monotonic() + duration_s

    def worker():
        while time.monotonic() < stop:
            t0 = time.monotonic()
            try:
                out = srv.infer(example, deadline_ms=None, timeout=timeout_s)
                dt = time.monotonic() - t0
                if check is not None:
                    check(out)
            except Exception as e:      # noqa: BLE001 — counted, surfaced
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                return
            with lock:
                lat.append(dt)

    threads = [threading.Thread(target=worker, name=f"pt-loadgen-{i}")
               for i in range(workers)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if not lat and errors:
        raise RuntimeError(
            f"closed_loop: every worker failed; first error: {errors[0]}")
    lat.sort()
    row = {"workers": workers, "duration_s": round(wall, 3),
           "served": len(lat), "req_per_s": round(len(lat) / wall, 1),
           "worker_errors": len(errors),
           "first_error": errors[0] if errors else None}
    return lat, row


def percentile(sorted_vals, q: float):
    """Rank-based percentile of an ascending list; None when empty."""
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]
