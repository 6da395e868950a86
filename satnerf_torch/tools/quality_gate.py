"""Paired-seed sine-engine quality gate (a copy of the JAX package's
``tools/quality_gate.py``; it reads JSON only).

Reads the ``results.json`` written by ``satnerf_torch.tools.ours_train_eval``
(or the JAX package's tool: the files are the same) for a matrix of
{sine engine} x {seed} training runs and renders the decision table,
applying the gate:

  a faster sine engine may become the default only if BOTH of its paired
  seeds land a DSM-MAE no worse than the worst ``poly`` (exact-fold
  baseline) seed, i.e. inside the baseline seed spread, AND the eval-time
  swap matrix (``satnerf_torch.tools.sin_swap_eval``) shows no systematic bias.

This script evaluates the first condition and prints the table; the swap
matrix is judged separately (it is a different axis: train-time engine
vs eval-time engine).

Usage:
    python -m satnerf_torch.tools.quality_gate <root> --engines poly,poly5,poly7f --seeds 0,1
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_run(root: str, engine: str, seed: int):
    path = os.path.join(root, f"{engine}_s{seed}", "results.json")
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        r = json.load(fh)
    return {k: v for k, v in r.items() if not isinstance(v, dict)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="directory holding <engine>_s<seed>/results.json")
    ap.add_argument("--engines", default="poly,poly5,poly7f")
    ap.add_argument("--baseline", default="poly")
    ap.add_argument("--seeds", default="0,1")
    args = ap.parse_args(argv)

    engines = args.engines.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]

    runs = {}
    for eng in engines:
        for seed in seeds:
            r = load_run(args.root, eng, seed)
            if r is None:
                print(f"MISSING {eng} seed {seed}", file=sys.stderr)
                return 1
            runs[(eng, seed)] = r

    cols = ["psnr", "ssim", "mae", "acc", "miou"]
    print("| engine / seed | " + " | ".join(["test/psnr", "ssim", "DSM-MAE (m)", "sem acc", "mIoU"]) + " |")
    print("|---|" + "---|" * len(cols))
    for eng in engines:
        for seed in seeds:
            r = runs[(eng, seed)]
            cells = [f"{r['psnr']:.3f}", f"{r['ssim']:.3f}", f"{r['mae']:.3f}",
                     f"{r['acc']:.4f}", f"{r['miou']:.3f}"]
            print(f"| {eng} seed {seed} | " + " | ".join(cells) + " |")

    base_maes = [runs[(args.baseline, s)]["mae"] for s in seeds]
    lo, hi = min(base_maes), max(base_maes)
    print()
    print(f"{args.baseline} (baseline) DSM-MAE seed spread: [{lo:.3f}, {hi:.3f}] m")
    verdicts = {}
    for eng in engines:
        if eng == args.baseline:
            continue
        maes = [runs[(eng, s)]["mae"] for s in seeds]
        # Lower MAE is strictly better: the gate only rejects seeds that
        # land ABOVE the baseline's worst seed.
        ok = all(m <= hi for m in maes)
        verdicts[eng] = ok
        worst = max(maes)
        rel = worst - hi
        print(f"GATE {eng}: maes={['%.3f' % m for m in maes]} worst={worst:.3f} "
              f"({'+' if rel >= 0 else ''}{rel:.3f} vs baseline worst) -> "
              f"{'PASS' if ok else 'FAIL'} (swap matrix still required)")
    print("DECISION " + json.dumps({"baseline_spread": [lo, hi], "pass": verdicts}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
