"""Process-level runtime flags (counterpart of ``paddle_tpu/flags.py``):
a typed registry with environment-variable override
(``PADDLE_TPU_TORCH_<NAME>``).  Only the flags the ported path reads are
defined."""
from __future__ import annotations

import os
from typing import Any, Dict

_registry: Dict[str, dict] = {}


def define_flag(name: str, default, help: str = "", type_=None):
    t = type_ or (type(default) if default is not None else str)
    _registry[name] = {"default": default, "help": help, "type": t,
                       "value": _from_env(name, default, t)}


def _from_env(name, default, t):
    env = os.environ.get(f"PADDLE_TPU_TORCH_{name.upper()}")
    if env is None:
        return default
    if t is bool:
        return env.lower() in ("1", "true", "yes", "on")
    return t(env)


def get_flag(name: str) -> Any:
    return _registry[name]["value"]


def set_flag(name: str, value):
    if name not in _registry:
        raise KeyError(f"unknown flag {name!r}; define_flag it first")
    _registry[name]["value"] = _registry[name]["type"](value) \
        if value is not None else None


define_flag("conv1x1_pallas", True,
            "route eligible 1x1 conv2d ops (groups=1, pad 0, dil 1, "
            "128-divisible dims) to the hand-written 1x1-conv matmul "
            "kernel (ops/conv1x1.py, csrc/conv1x1_mm.cu) instead of a "
            "plain convolution; on by default in this package so the "
            "served path runs its kernel.  The name is the JAX package's. "
            "Per-executor override: Executor(conv1x1_pallas=...), "
            "per-layer override: layers.conv2d(use_pallas=...)")
define_flag("log_period", 100, "steps between the trainer's periodic "
            "observability reports (Flags.cpp:62); read only while "
            "observing")
define_flag("observe", False,
            "runtime observability (paddle_tpu_torch.observability): "
            "per-dispatch step telemetry into the metrics registry, "
            "spans, NVTX ranges around each dispatch, and JSONL export "
            "when metrics_log is set.  No registry write, span or log "
            "line, and no new capture key, when off.  Per-executor "
            "override: Executor(observe=...)")
define_flag("metrics_log", "",
            "JSONL structured metrics/event log path; empty = off.  "
            "Read it with observability.summarize_log / iter_log_events")
define_flag("validate", False,
            "run the static program verifier (paddle_tpu_torch.analysis) "
            "before a program's first step: a malformed graph fails with "
            "a stable PT0xx diagnostic naming the op, never captured; "
            "memoized per (program version, fetches).  Per-executor "
            "override: Executor(validate=...); per-call: "
            "trainer.SGD.train(validate=...)")
define_flag("cache_dir", "",
            "persistent cache root (PADDLE_TPU_TORCH_CACHE_DIR); empty = "
            "off.  The autotuner keeps its records under <cache_dir>/"
            "tuning/ (tuning/store.py); Executor.compile keeps what a "
            "cold compile learned as <cache_dir>/ptxc-<fingerprint>.pkl "
            "(core/compile_cache.py)")
define_flag("autotune", False,
            "replay persisted autotuner winners (paddle_tpu_torch.tuning) "
            "at the tuned call sites: run_pipelined dispatch chunking, "
            "reader prefetch workers and buffer, the serving batcher, the "
            "decode slot pool, the sparse session's knobs, and the flash "
            "attention layer's ring depths.  Off: every call site takes "
            "today's default, the same object.  On with no record: the "
            "defaults again; replay never searches.  Per-instance "
            "override: Executor(autotune=...), Server(autotune=...), "
            "DecodeEngine/DecodeRuntime(autotune=...); search with "
            "`python -m paddle_tpu_torch tune <target>`  "
            "(PADDLE_TPU_TORCH_AUTOTUNE=1)")
