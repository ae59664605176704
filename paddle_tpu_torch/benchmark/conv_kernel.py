"""K1 against the library, per (shape, form), and K1's launch plans
through the autotuner (the port's counterpart of the JAX package's
``benchmark/conv_kernel.py``).

Per row, at ResNet-50's eligible 1x1 shapes (batch 128) and GoogLeNet's
four (inception 3b's and 4c's ``c1`` and ``c3r``, batch 128), the same
product on both sides, in bf16:

    forward  out[P, M] = x[P, C] @ w[M, C]^T     (ta=False, tb=True)
    dgrad    dx[P, C]  = g[P, M] @ w[M, C]       (ta=False, tb=False)
    wgrad    dw[M, C]  = g[P, M]^T @ x[P, C]     (ta=True,  tb=False)

``ms`` is ``conv1x1.mm`` (the plan ``plan()`` makes), ``matmul_ms``
``torch.matmul`` on the same operands (both CUDA events, median of
windows), ``max_abs_err`` the kernel against ``mm_reference``.  Then,
for every wgrad shape, ``tuning.search.tune`` over ``cuda/conv1x1_plan``
(the target ``tuning.targets`` builds at that shape, ``save=False``):
each candidate plan's ms a launch, failed where ``conv1x1.check_launch``
refuses it before launch, and the A/B's verdict against the rule.

    python -m paddle_tpu_torch.benchmark.conv_kernel [--out PATH]
    python -m paddle_tpu_torch.benchmark.conv_kernel --smoke --device cpu
    python -m paddle_tpu_torch.benchmark.conv_kernel --slab-accuracy

``--slab-accuracy`` measures what ``conv1x1.MAX_BF16_SLAB_STEPS`` rests
on: at each wgrad shape of the plan search, one plan a slab length (S
slabs in clusters of min(S, 8), S from 1 up), launched with the bound
lifted for the measurement, and its largest error over the limit
(``max |K1 - mm_reference| / (atol + rtol |mm_reference|)``, the bf16
``deep_tol`` of ``chip_smoke.py``: rtol 1.6e-2, atol max(1e-2, 2e-7 K)).

Results go to ``build/conv_kernel_results.json`` (not with ``--smoke``
unless ``--out`` is given), beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..tuning import search, targets
from .harness import device_label, write_results

# ResNet-50 at batch 128: every 1x1 shape the routing gate accepts
# (name, N, C, H, W, M, stride), the JAX driver's list
RESNET50 = [
    ("c512_m128_hw28", 128, 512, 28, 28, 128, 1),
    ("c128_m512_hw28", 128, 128, 28, 28, 512, 1),
    ("c1024_m256_hw14", 128, 1024, 14, 14, 256, 1),
    ("c256_m1024_hw14", 128, 256, 14, 14, 1024, 1),
    ("c2048_m512_hw7", 128, 2048, 7, 7, 512, 1),
    ("c512_m2048_hw7", 128, 512, 7, 7, 2048, 1),
    ("c1024_m2048_s2_hw14", 128, 1024, 14, 14, 2048, 2),
]
# GoogLeNet at batch 128 on 224 x 224: inception 3b's c1 and c3r (27 x 27)
# and 4c's (13 x 13), as (name, P, C, M)
GOOGLENET = [("3b_c1", 93312, 256, 128), ("3b_c3r", 93312, 256, 128),
             ("4c_c1", 21632, 512, 128), ("4c_c3r", 21632, 512, 128)]
SMOKE = [("tiny_c256_m128", 2048, 256, 128)]
FORMS = {"forward": (False, True), "dgrad": (False, False),
         "wgrad": (True, False)}


def shapes(smoke: bool = False):
    """(name, P, C, M) of every measured shape."""
    if smoke:
        return list(SMOKE)
    out = [(n, N * (H // s) * (W // s), C, M)
           for n, N, C, H, W, M, s in RESNET50]
    return out + [("googlenet_" + n, P, C, M) for n, P, C, M in GOOGLENET]


def _operands(form, P, C, M, dev, gen, dtype):
    def rn(*s):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)
    x, w, g = rn(P, C), rn(M, C), rn(P, M)
    return {"forward": (x, w), "dgrad": (g, w), "wgrad": (g, x)}[form]


def _ms(fn, reps, steps, on_card):
    """Median ms of one call over ``reps`` windows of ``steps`` calls
    (CUDA events on the card, the host clock on the CPU)."""
    if on_card:
        from ..observability.opprof import cuda_time_windows as tw
    else:
        tw = search.time_windows

    def window():
        for _ in range(steps):
            fn()
    return tw(window, reps=reps, warmup=1, unit=steps)["seconds"] * 1e3


def slab_accuracy(smoke: bool = False, quiet: bool = False) -> list:
    """Rows of (shape, slabs, K steps a slab, largest error / limit) of
    the bf16 wgrad, with the slab bound lifted while they launch."""
    from ..ops import conv1x1
    rows = []
    seen = set()
    prev = conv1x1.MAX_BF16_SLAB_STEPS
    conv1x1.MAX_BF16_SLAB_STEPS = 1 << 30
    # plan() reads the bound too: no plan made without it may stay cached
    conv1x1.plan.cache_clear()
    try:
        for name, P, C, M in shapes(smoke):
            if (P, C, M) in seen:
                continue
            seen.add((P, C, M))
            measure = targets.build_target(
                "cuda/conv1x1_plan", smoke=smoke, shape=(P, C, M), steps=1)
            gout, x = measure.operands
            ref = conv1x1.mm_reference(gout, x, True, False).float()
            lim = max(1e-2, 2e-7 * P) + 1.6e-2 * ref.abs()
            rule = conv1x1.plan(M, C, P, True, False)
            for splits in sorted({1, 2, 4, 8, 16, 32, rule.splits}):
                if splits > rule.ksteps:
                    continue
                cfg = {"splits": splits, "cluster": min(splits, 8),
                       "persistent": False}
                dw = conv1x1.mm(gout, x, True, False, config=cfg).float()
                used = ((dw - ref).abs() / lim).max().item()
                row = {"shape": name, "P": P, "C": C, "M": M,
                       "splits": splits, "slab_steps":
                       -(-rule.ksteps // splits), "rule": splits ==
                       rule.splits, "error_over_limit": used}
                rows.append(row)
                if not quiet:
                    print(json.dumps(row), flush=True)
            del measure, gout, x, ref
    finally:
        conv1x1.MAX_BF16_SLAB_STEPS = prev
        conv1x1.plan.cache_clear()
    return rows


def run_all(smoke: bool = False, device: str = "cuda", quiet=False,
            search_plans: bool = True) -> dict:
    from ..ops import conv1x1
    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("conv_kernel: no CUDA card (run with --device "
                           "cpu for the path check)")
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    reps, steps = (2, 2) if smoke else (5, 20)
    rows, searches = [], []
    for name, P, C, M in shapes(smoke):
        for form, (ta, tb) in FORMS.items():
            a, b = _operands(form, P, C, M, device, gen, dtype)
            got = conv1x1.mm(a, b, ta, tb)
            want = conv1x1.mm_reference(a, b, ta, tb)
            A = a.t() if ta else a
            B = b.t() if tb else b
            row = {"shape": name, "P": P, "C": C, "M": M, "form": form,
                   "plan": {k: getattr(conv1x1.plan(
                       *conv1x1._dims(a, b, ta, tb), ta, tb, dtype,
                       conv1x1._sm_count(a.device) if on_card else 132),
                       k) for k in ("splits", "cluster", "partials",
                                    "ctas")},
                   "max_abs_err": (got.float() - want.float()).abs().max()
                   .item(),
                   "ms": _ms(lambda: conv1x1.mm(a, b, ta, tb), reps, steps,
                             on_card),
                   "matmul_ms": _ms(lambda: torch.matmul(A, B), reps, steps,
                                    on_card)}
            row["ratio_to_matmul"] = row["ms"] / row["matmul_ms"]
            rows.append(row)
            if not quiet:
                print(json.dumps(row), flush=True)
            del a, b, got, want
    if search_plans:
        seen = set()
        for name, P, C, M in shapes(smoke):
            if (P, C, M) in seen:
                continue
            seen.add((P, C, M))
            measure = targets.build_target(
                "cuda/conv1x1_plan", smoke=smoke, shape=(P, C, M))
            doc = search.tune(
                "cuda/conv1x1_plan", measure, reps=reps, pairs=5,
                context=measure.context, save=False)
            entry = {"shape": name, "P": P, "C": C, "M": M,
                     "status": doc["status"]}
            if doc["status"] != "pending_hardware":
                entry["trials"] = [
                    {"config": t["config"], "status": t["status"],
                     "ms": None if t["seconds"] is None
                     else t["seconds"] / measure.steps * 1e3,
                     "error": t["error"]}
                    for t in doc["search"]["trials"]]
                entry["best"] = doc["search"]["best"]
                if "ab" in doc:
                    entry["ab"] = doc["ab"]
            searches.append(entry)
            if not quiet:
                print(json.dumps({k: entry[k] for k in
                                  ("shape", "status")}
                                 | {"best": entry.get("best")}), flush=True)
    return {"device": device_label() if on_card else "cpu",
            "dtype": "bf16", "smoke": smoke, "rows": rows,
            "plan_search": searches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one tiny shape; writes a results file only with "
                         "--out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--no-search", action="store_true",
                    help="the per-form table only")
    ap.add_argument("--slab-accuracy", action="store_true",
                    help="the bf16 wgrad's error against its slab length "
                         "only (the MAX_BF16_SLAB_STEPS measurement)")
    ap.add_argument("--out", default=None,
                    help="results path (default "
                         "build/conv_kernel_results.json)")
    args = ap.parse_args(argv)
    if args.slab_accuracy:
        doc = {"device": device_label() if args.device == "cuda" else "cpu",
               "dtype": "bf16", "smoke": args.smoke,
               "slab_accuracy": slab_accuracy(args.smoke)}
        write_results(args.out, args.smoke, "conv_slab_accuracy.json",
                      "conv1x1_bf16_slab_accuracy", doc)
        return doc
    doc = run_all(smoke=args.smoke, device=args.device,
                  search_plans=not args.no_search)
    write_results(args.out, args.smoke, "conv_kernel_results.json",
                  "conv1x1_kernel_vs_matmul", doc)
    return doc


if __name__ == "__main__":
    main()
