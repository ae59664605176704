"""Persistence and replay of autotuner winners (counterpart of
``paddle_tpu/tuning/store.py``).

A winner is one JSON file under ``<cache_dir>/tuning/`` named
``ptat-<fingerprint>.json``:

* **Keying** — :func:`record_fingerprint` hashes (``TUNING_FORMAT``, the
  tunable's name, its :func:`~.tunables.space_digest`, the card
  (:func:`topology_key`), the context) through
  ``core.compile_cache.fingerprint_hex``, which folds in the torch, CUDA
  and port versions.  A new torch or port, another card, an edited
  declaration or another context each give another fingerprint: the old
  record is never found, and the call site keeps its default.
  ``context`` is a free-form site key (a kernel's shape, say) for
  tunables whose winner depends on it.
* **Writes** — a temporary file and ``os.replace``, so a reader never
  sees half a record.
* **Replay** — :func:`tuned` is the one surface the call sites touch:
  the stored winner merged over the caller's default, or the default
  object itself.  Lookups are memoized per (name, context), misses too,
  so a process probes the disk at most once a call site; a corrupt,
  foreign or schema-drifted record falls back to the default with a
  warning, never an error.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from ..core import compile_cache
from ..core.registry import get_tunable
from ..testing import lockwatch as _lw
from . import tunables as _tn

logger = logging.getLogger("paddle_tpu_torch")

__all__ = [
    "TUNING_FORMAT", "store_dir", "topology_key", "record_fingerprint",
    "record_path", "save_record", "load_record", "tuned", "clear_memo",
    "probes", "list_records",
]

TUNING_FORMAT = 1               # bump to invalidate every stored winner
_PREFIX = "ptat-"

_lock = _lw.make_lock("tuning.store")
#: (name, context, base) -> record dict or None (misses memoized too)
_memo: Dict[tuple, Optional[dict]] = {}
#: (name, context, base) -> disk probes tuned() made (1 each, memo kept)
_probes: Dict[tuple, int] = {}


def store_dir(base: Optional[str] = None) -> str:
    """The record directory ('' = persistence off).  ``base`` overrides
    the ``cache_dir`` flag (the command line's ``--cache-dir``, tests)."""
    d = base if base is not None else compile_cache.cache_dir()
    return os.path.join(d, "tuning") if d else ""


def topology_key():
    """The device part of a fingerprint: the card's name and the number
    of cards, or ``("cpu", 0)`` where none is present.  A winner tuned on
    one card does not replay on another."""
    if not torch.cuda.is_available():
        return ("cpu", 0)
    return (torch.cuda.get_device_name(0), torch.cuda.device_count())


def record_fingerprint(name: str, context: str = "") -> str:
    entry = get_tunable(name)
    return compile_cache.fingerprint_hex(
        ("tunable", TUNING_FORMAT, name, _tn.space_digest(entry),
         topology_key(), str(context)))


def record_path(name: str, context: str = "",
                base: Optional[str] = None) -> str:
    d = store_dir(base)
    if not d:
        return ""
    return os.path.join(d, f"{_PREFIX}{record_fingerprint(name, context)}"
                           f".json")


def save_record(name: str, config: Dict[str, object], *,
                context: str = "", base: Optional[str] = None,
                **extra) -> str:
    """Persist a winner atomically; its path ('' when persistence is
    off).  ``extra`` (score, speedup, windows, ...) is stored as given;
    replay reads only ``config``."""
    entry = get_tunable(name)
    problems = _tn.validate_config(entry, config)
    if problems:
        raise ValueError(f"save_record({name!r}): config does not match "
                         f"the declared space: {problems}")
    d = store_dir(base)
    if not d:
        return ""
    fp = record_fingerprint(name, context)
    payload = {
        "format": TUNING_FORMAT, "fingerprint": fp, "tunable": name,
        "context": str(context), "config": dict(config),
        "space_digest": _tn.space_digest(entry),
        "topology": list(topology_key()),
        "environment": list(compile_cache.environment_key()),
        "created": round(time.time(), 3),
        **extra,
    }
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=_PREFIX, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        path = os.path.join(d, f"{_PREFIX}{fp}.json")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    with _lock:
        # the writing process replays its own new winner
        for k in [k for k in _memo if k[0] == name and k[1] == str(context)]:
            del _memo[k]
    return path


def load_record(name: str, context: str = "",
                base: Optional[str] = None) -> Optional[dict]:
    """The valid persisted record of (name, context), or None.  Every
    failure is a miss, never an error: no file, unreadable or truncated
    JSON, another format or fingerprint, another tunable's name, or a
    config the declared space no longer admits.  Misses other than a
    missing file log a warning naming the file."""
    path = record_path(name, context, base)
    if not path:
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        logger.warning("tuning store: unreadable record %s (%s: %s); "
                       "using defaults", path, type(e).__name__, e)
        return None
    fp = record_fingerprint(name, context)
    if not isinstance(payload, dict) \
            or payload.get("format") != TUNING_FORMAT \
            or payload.get("fingerprint") != fp \
            or payload.get("tunable") != name \
            or not isinstance(payload.get("config"), dict):
        logger.warning("tuning store: stale/foreign record %s "
                       "(format/fingerprint mismatch); using defaults",
                       path)
        return None
    problems = _tn.validate_config(get_tunable(name), payload["config"])
    if problems:
        logger.warning("tuning store: record %s no longer matches the "
                       "declared space (%s); using defaults", path,
                       "; ".join(problems))
        return None
    return payload


def tuned(name: str, default: Dict[str, object], *, context: str = "",
          base: Optional[str] = None) -> Dict[str, object]:
    """The replay lookup: the persisted winner of (name, context) merged
    over ``default`` (only the keys ``default`` has), or ``default``
    itself when no valid record exists.  One disk probe per (name,
    context, base) and process; a changed ``cache_dir`` flag needs
    :func:`clear_memo`."""
    key = (name, str(context), base)
    with _lock:
        hit = key in _memo
        payload = _memo.get(key)
    if not hit:
        payload = load_record(name, context, base)
        with _lock:
            _memo[key] = payload
            _probes[key] = _probes.get(key, 0) + 1
        if payload is not None:
            # once per (site, process): the replay shows in `stats`
            from ..observability import emit_event, inc_counter
            inc_counter("tuning/replays")
            emit_event("tuning", event="replay", tunable=name,
                       context=str(context), config=payload["config"])
    if payload is None:
        return default
    cfg = payload["config"]
    return {k: cfg.get(k, v) for k, v in default.items()}


def clear_memo():
    """Forget the memoized lookups (tests, a changed store)."""
    with _lock:
        _memo.clear()
        _probes.clear()


def probes() -> Dict[tuple, int]:
    """{(name, context, base): disk probes} that :func:`tuned` made since
    the last :func:`clear_memo` (1 each while the memo holds)."""
    with _lock:
        return dict(_probes)


def list_records(base: Optional[str] = None):
    """(path, payload) of every record in the store (payload None where
    it does not read)."""
    d = store_dir(base)
    if not d or not os.path.isdir(d):
        return []
    out = []
    for fn in sorted(os.listdir(d)):
        if not (fn.startswith(_PREFIX) and fn.endswith(".json")):
            continue
        path = os.path.join(d, fn)
        try:
            with open(path) as f:
                out.append((path, json.load(f)))
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            out.append((path, None))
    return out
