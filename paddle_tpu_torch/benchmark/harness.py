"""What the port's benchmark runners (``ctr``, ``decode``, ``serving``,
``pserver``, ``checkpoint``) share.

* :func:`paired_ab`: the paired alternating A/B (the port's copy of
  ``paddle_tpu/tuning/search.py:258-304``).  Windows of the default and
  the candidate alternate, so a slow stretch of a shared host falls on
  both arms; the verdict is the median of the per-pair time ratios with
  a noise gate, and the raw windows ride along so a refusal can be read.
* :func:`write_results`: a runner's results file, under ``build/`` of
  the checkout by default.
* :func:`device_label`: what a row ran on: the card's name and power
  limit, or ``cpu``.
* :func:`observed`: a doctor pass's window, observing into a fresh JSONL
  log under ``build/doctor/`` of the checkout.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import time

import numpy as np

__all__ = ["paired_ab", "write_results", "device_label", "observed"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LOG_SEQ = itertools.count()


def paired_ab(measure, default_config, candidate_config, *, pairs=5,
              warmup=1, min_speedup=1.10, min_winning_fraction=0.75):
    """Run ``warmup`` untimed pairs, then ``max(2, pairs)`` timed pairs of
    ``measure(config)``, default first in each.  Accepted when the median
    of default/candidate time ratios reaches ``min_speedup`` and at least
    ``min_winning_fraction`` of the pairs favour the candidate.  Returns
    the verdict with the raw windows."""
    for _ in range(max(0, warmup)):
        measure(dict(default_config))
        measure(dict(candidate_config))
    d_windows, c_windows = [], []
    for _ in range(max(2, pairs)):
        t0 = time.perf_counter()
        measure(dict(default_config))
        d_windows.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        measure(dict(candidate_config))
        c_windows.append(time.perf_counter() - t0)
    ratios = [d / c for d, c in zip(d_windows, c_windows)]
    med = float(np.median(ratios))
    winning = sum(1 for r in ratios if r > 1.0) / len(ratios)
    accepted = med >= min_speedup and winning >= min_winning_fraction
    if accepted:
        reason = None
    elif med < min_speedup:
        reason = (f"median pair ratio {med:.3f} < min_speedup "
                  f"{min_speedup}: inside the noise band")
    else:
        reason = (f"only {winning:.0%} of pairs favor the candidate "
                  f"(< {min_winning_fraction:.0%})")
    return {"speedup": med, "pair_ratios": ratios,
            "default_windows": d_windows, "candidate_windows": c_windows,
            "min_speedup": min_speedup,
            "min_winning_fraction": min_winning_fraction,
            "accepted": bool(accepted), "refusal_reason": reason}


def write_results(out, smoke, default_name, benchmark, row):
    """Write ``{"benchmark", "device", "rows": [row]}`` to ``out``, or to
    ``build/<default_name>`` of the checkout when ``out`` is None and the
    run is not ``smoke``."""
    out = out or (None if smoke else os.path.join(_ROOT, "build",
                                                   default_name))
    if not out:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"benchmark": benchmark, "device": row["device"],
                   "rows": [row]}, f, indent=1)
    print(f"# wrote {out}", file=sys.stderr)
    return out


def device_label(place=None) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu``: for ``place``, or (a host-side runner's row, ``place``
    None) for the machine, by whether torch sees a card."""
    import torch
    on_card = torch.cuda.is_available() if place is None \
        else place.device().type == "cuda"
    if not on_card:
        return "cpu"
    from .bandwidth import card_line
    return card_line()


@contextlib.contextmanager
def observed(name: str):
    """Turn the ``observe`` flag on and point ``metrics_log`` at a fresh
    ``build/doctor/<name>_<pid>_<n>.jsonl``
    of the checkout for the block; yields the path.  The flags are
    restored and the writer closed after it, so the log is complete.
    Each call takes a new path: the writer reopens only on a change of
    path."""
    from .. import flags
    from ..observability import export
    path = os.path.join(_ROOT, "build", "doctor",
                        f"{name}_{os.getpid()}_{next(_LOG_SEQ)}.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    prev = {n: flags.get_flag(n) for n in ("observe", "metrics_log")}
    flags.set_flag("observe", True)
    flags.set_flag("metrics_log", path)
    try:
        yield path
    finally:
        for n, v in prev.items():
            flags.set_flag(n, v)
        export._reset_writer()
