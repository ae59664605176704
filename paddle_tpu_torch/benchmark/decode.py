"""Continuous-batching incremental decode benchmark on a CUDA card: the
KV-cache slot pool (``paddle_tpu_torch.serving.decode``) against a
static-batch control (the port's counterpart of the JAX package's
``benchmark/decode.py``).

Both arms run the same two programs (batch-1 prefill and batch-S
one-token decode over the cache slabs, each one captured CUDA graph on a
card) on the same mixed-length request trace; only the scheduler
differs:

* ``continuous``: at every token step finished sequences are completed
  at once and queued requests take the freed slots;
* ``static``: requests enter only an empty pool, and the batch runs
  until its slowest member finishes.

Rows, each beside the card's name and power limit:

* ``decode_tokens_per_s``: generated tokens over the window's wall;
* ``ttft_ms``: p50/p99 of admission to first token;
* ``inter_token_ms``: p50/p99 of the gap between a sequence's tokens;
* ``slot_occupancy``: live slots over all slots at decode steps;
* ``ab``: alternating static/continuous windows
  (``tuning.search.paired_ab``), gate 1.3x decode tokens/s;
* ``arms_tokens_identical``: every request's tokens equal across the
  two schedulers.

``doctor``: one extra observed continuous window after the A/B (the A/B's
pools do not observe: no span, metric or log line): the doctor's
token-step budget
(``attribution.decode_budget``) and the decode section of the log's
summary.

    python -m paddle_tpu_torch.benchmark.decode [--smoke] [--out PATH]
        [--device cuda|cpu]
    python -m paddle_tpu_torch.benchmark.run --model decode [--smoke]

Results go to ``build/decode_results.json`` (not with ``--smoke`` unless
``--out`` is given).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .harness import device_label, observed, write_results


FULL = {
    "vocab": 256,
    "hidden": 64,
    "n_layers": 2,
    "slots": 8,
    "max_len": 64,
    "n_requests": 24,
    "prompt_lens": (4, 6, 8, 12),
    "max_news": (4, 8, 8, 48),      # a long tail: the static arm pads
                                    # every round to its slowest member
    "ab_pairs": 5,
    "warmup": 1,
    "min_speedup": 1.3,
}
SMOKE = {
    "vocab": 64,
    "hidden": 32,
    "n_layers": 1,
    "slots": 4,
    "max_len": 32,
    "n_requests": 6,
    "prompt_lens": (3, 5, 7),
    "max_news": (2, 4, 8),
    "ab_pairs": 2,
    "warmup": 1,
    "min_speedup": 1.3,
}


def trace(cfg, seed=0):
    """The shared mixed-length request trace: (prompt, max_new) pairs.
    No EOS, so every request generates exactly max_new tokens."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(cfg["n_requests"]):
        plen = cfg["prompt_lens"][i % len(cfg["prompt_lens"])]
        prompt = [int(t) for t in rng.randint(1, cfg["vocab"], plen)]
        out.append((prompt, cfg["max_news"][i % len(cfg["max_news"])]))
    return out


def build_pool(cfg, mode, place=None, observe=False):
    """A started slot pool of ``mode`` (engine warmed up: both programs
    captured on a card), writing its metrics and spans if ``observe``."""
    from ..serving.decode import DecodeEngine, DecodeRuntime

    eng = DecodeEngine(
        vocab_size=cfg["vocab"], hidden_dim=cfg["hidden"],
        n_layers=cfg["n_layers"], slots=cfg["slots"],
        max_len=cfg["max_len"], eos_id=None, seed=7,
        name=f"bench-{mode}", place=place)
    rt = DecodeRuntime(eng, mode=mode, step_wait_ms=0.5,
                       default_deadline_ms=None, observe=observe)
    rt.start(warmup=True)
    return rt


def run_window(rt, reqs):
    """Submit the whole trace at once, wait for every completion;
    returns (wall_s, outputs)."""
    t0 = time.perf_counter()
    pending = [rt.submit(p, m) for p, m in reqs]
    outs = [r.result(timeout=600.0) for r in pending]
    return time.perf_counter() - t0, outs


def _pctl(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else None


def arm_row(rt, outs, wall_s, h0, h1):
    tokens = sum(len(o["tokens"]) for o in outs)
    ttfts = [o["ttft_ms"] for o in outs if o["ttft_ms"] is not None]
    inter = [g for o in outs for g in o["inter_token_ms"]]
    steps = h1["steps"] - h0["steps"]
    # decode-step tokens: all generated but the prefills' first tokens
    step_tokens = (h1["tokens"] - h0["tokens"]) - len(outs)
    return {
        "mode": rt.mode,
        "tokens": tokens,
        "decode_tokens_per_s": tokens / wall_s,
        "wall_s": wall_s,
        "ttft_ms": {"p50": _pctl(ttfts, 50), "p99": _pctl(ttfts, 99)},
        "inter_token_ms": {"p50": _pctl(inter, 50),
                           "p99": _pctl(inter, 99)},
        "decode_steps": steps,
        "slot_occupancy": step_tokens / (steps * rt.engine.slots)
        if steps else None,
    }


def run_ab(cfg, place=None, quiet=False):
    """One persistent pool per mode (built and captured outside every
    timed window), alternating windows over the same trace, paired at
    the 1.3x bar; then one more window per arm for its rows."""
    reqs = trace(cfg)
    pools = {m: build_pool(cfg, m, place) for m in ("static", "continuous")}
    try:
        last_outs = {}

        def measure(config):
            _, last_outs[config["mode"]] = run_window(
                pools[config["mode"]], reqs)

        from ..tuning.search import paired_ab
        ab = paired_ab(measure, {"mode": "static"},
                       {"mode": "continuous"}, pairs=cfg["ab_pairs"],
                       warmup=cfg["warmup"],
                       min_speedup=cfg["min_speedup"])
        rows = {}
        for mode, rt in pools.items():
            h0 = rt.health()
            wall, outs = run_window(rt, reqs)
            rows[mode] = arm_row(rt, outs, wall, h0, rt.health())
            last_outs[mode] = outs
        # scheduling must be invisible to the math
        identical = all(
            a["tokens"] == b["tokens"]
            for a, b in zip(last_outs["static"], last_outs["continuous"]))
        keys = {m: len(rt.engine.keys) for m, rt in pools.items()}
    finally:
        for rt in pools.values():
            rt.shutdown(drain=True, timeout=60.0)
    row = {"ab": ab, "static": rows["static"],
           "continuous": rows["continuous"],
           "arms_tokens_identical": bool(identical),
           "capture_keys": keys}
    if not quiet:
        print(json.dumps({
            "arm": "decode_ab", "speedup": ab["speedup"],
            "accepted": ab["accepted"],
            "static_tokens_per_s": rows["static"]["decode_tokens_per_s"],
            "continuous_tokens_per_s":
                rows["continuous"]["decode_tokens_per_s"],
            "arms_tokens_identical": bool(identical)}), flush=True)
    return row


def run_doctor_pass(cfg, place=None, quiet=False):
    """One extra observed continuous window (the pool is built, warmed
    and captured before the log opens): the doctor's token-step budget
    and the decode section of the log's summary."""
    from ..observability import attribution, summarize_logs
    rt = build_pool(cfg, "continuous", _place(place), observe=True)
    try:
        with observed("decode") as log:
            run_window(rt, trace(cfg))
    finally:
        rt.shutdown(drain=True, timeout=60.0)
    row = {"doctor": attribution.doctor_report([log]).get("decode"),
           "stats_decode": summarize_logs([log]).get("decode")}
    if not quiet:
        print(json.dumps({"arm": "doctor", **row}), flush=True)
    return row


def _place(place):
    from ..core import CUDAPlace
    return CUDAPlace(0) if place is None else place


def run_all(cfg=None, smoke=False, place=None, quiet=False):
    cfg = cfg or (SMOKE if smoke else FULL)
    place = _place(place)
    row = run_ab(cfg, place, quiet=quiet)
    doctor_row = run_doctor_pass(cfg, place, quiet=quiet)
    return {"config": dict(cfg), **row, **doctor_row,
            "device": device_label(place), "smoke": bool(smoke)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes; writes a results file only with "
                         "--out")
    ap.add_argument("--out", default=None,
                    help="results path (default build/decode_results.json)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from ..core import CPUPlace
    row = run_all(smoke=args.smoke,
                  place=CPUPlace() if args.device == "cpu" else None)
    print(json.dumps(row, indent=1))
    write_results(args.out, args.smoke, "decode_results.json",
                  "decode_continuous_batching", row)
    return row


if __name__ == "__main__":
    main()
