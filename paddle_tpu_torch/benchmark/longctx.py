"""Long-context attention on K2-K4: causal flash-attention training steps
at 16k-64k tokens on one card, and the sweep of the kernels' ring depths
through the autotuner (the port's counterpart of the JAX package's
``benchmark/longctx.py``, its default table and ``--sweep``).

A step is one forward (K2) and one backward (K3, then K4) at 8 heads x
T x d 64, causal, bf16, on the kernels' wrappers; a window is ``steps``
of them, ended on the card's synchronize (``tuning.search``'s harness:
a discarded warm-up window, the median of the rest).

    python -m paddle_tpu_torch.benchmark.longctx           default table
                                                           (16k/32k/64k,
                                                           the plans'
                                                           depths)
    python -m paddle_tpu_torch.benchmark.longctx --sweep   32k and 64k over
                                                           every
                                                           cuda/flash_attention
                                                           config, each
                                                           through
                                                           run_trial
    ... --smoke --device cpu                               the path check
                                                           (T 256, the plain
                                                           versions)

Table rows: ``tokens``, ``ms_per_step``, ``tokens_per_sec``,
``attn_tflops`` (the causal pairs' products, forward and backward) and
``spread_pct``.  Sweep rows: the config, then those numbers, or the
trial's error (a config that fails is a recorded row).  Results go to
``build/longctx_results.json`` (not with ``--smoke`` unless ``--out`` is
given), beside the card's name and power limit.  The JAX driver's
``--framework`` mode is ``chip_smoke.py``'s ``[attention] train`` here.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..tuning import search, targets
from ..tuning.tunables import get_tunable, grid_configs
from .harness import device_label, write_results

HEADS, DIM = 8, 64
TABLE_T = (16384, 32768, 65536)
SWEEP_T = (32768, 65536)
SMOKE_T = (256,)


def _steps_for(T: int) -> int:
    """Steps a window: about a few windows a second at 16k-64k."""
    return max(2, min(30, int(2e9 // (T * T // 64))))


def attn_flops(T: int, dim: int = DIM) -> float:
    """The causal step's products: the forward's 2 (s, p v) and the
    backward's 5 (s, dp, dv, dq, dk) matrix products over the T (T + 1)
    / 2 kept pairs of each head, 2 operations a multiply-add."""
    return 7 * 2 * HEADS * (T * (T + 1) / 2) * dim


def _row(base: dict, trial, T: int, steps: int) -> dict:
    row = dict(base)
    if trial.status == "ok":
        s = trial.seconds / steps
        row.update(ms_per_step=s * 1e3, tokens_per_sec=T / s,
                   attn_tflops=attn_flops(T) / s / 1e12,
                   spread_pct=trial.spread_pct)
    else:
        row.update(status=trial.status,
                   error=(trial.error or trial.status)[:200])
    return row


def default_table(smoke: bool = False, quiet: bool = False):
    """The plans' own depths at each T of the table."""
    default = get_tunable("cuda/flash_attention")["default"]
    rows = []
    for T in (SMOKE_T if smoke else TABLE_T):
        steps = 1 if smoke else _steps_for(T)
        measure = targets.build_target("cuda/flash_attention", smoke=smoke,
                                       T=T, steps=steps)
        trial = search.run_trial(measure, default, reps=2 if smoke else 3,
                                 warmup=1, trial_timeout_s=600.0)
        row = _row({"tokens": T}, trial, T, steps)
        rows.append(row)
        if not quiet:
            print(json.dumps(row), flush=True)
        del measure
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


def sweep(smoke: bool = False, quiet: bool = False):
    """Every ``cuda/flash_attention`` config at 32k and 64k, each through
    ``run_trial``: its row, or its failure as the row."""
    entry = get_tunable("cuda/flash_attention")
    rows = []
    for T in (SMOKE_T if smoke else SWEEP_T):
        steps = 1 if smoke else _steps_for(T)
        measure = targets.build_target("cuda/flash_attention", smoke=smoke,
                                       T=T, steps=steps)
        for cfg in grid_configs(entry):
            trial = search.run_trial(measure, cfg, reps=2 if smoke else 3,
                                     warmup=1, trial_timeout_s=600.0)
            row = _row({"tokens": T, **cfg,
                        "default": cfg == entry["default"]},
                       trial, T, steps)
            rows.append(row)
            if not quiet:
                print(json.dumps(row), flush=True)
        del measure
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


def run_all(smoke: bool = False, do_sweep: bool = False,
            quiet: bool = False) -> dict:
    doc = {"device": device_label(), "heads": HEADS, "dim": DIM,
           "causal": True, "dtype": "bf16", "smoke": smoke}
    if do_sweep:
        doc["sweep"] = sweep(smoke, quiet)
    else:
        doc["table"] = default_table(smoke, quiet)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="every cuda/flash_attention config at 32k and "
                         "64k tokens")
    ap.add_argument("--smoke", action="store_true",
                    help="T 256; writes a results file only with --out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None,
                    help="results path (default build/longctx_results.json)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("longctx: no CUDA card (run with --smoke --device "
                         "cpu for the path check)")
    doc = run_all(smoke=args.smoke, do_sweep=args.sweep)
    write_results(args.out, args.smoke, "longctx_results.json",
                  "longctx_flash_attention", doc)
    return doc


if __name__ == "__main__":
    main()
