"""Time-to-parity: the earliest step and minute at which a curve run
crosses the converged quality of the torch reference on the trained-vs-
trained anchor scene (a copy of the JAX package's ``tools/time_to_parity.py``;
it reads JSON only).

The default thresholds are the reference's converged values recorded in
``docs/validation_run.md`` (its round-3 learning-curve anchor). The tool
scans curve runs (``results_step{N}.json`` written by
``satnerf_torch.tools.ours_train_eval --eval-at``) for the earliest horizon
that meets ALL thresholds, and converts steps to one-device minutes from
the run's own measured training time, plus the arithmetic N-device
projection.

Usage:
  python -m satnerf_torch.tools.time_to_parity <curve_run_dp> [...] \
      [--psnr 26.24] [--miou 0.184] [--acc 0.811] [--mae 1.46]
      [--batch 1024] [--rate-rays-s R] [--chips 8]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys


def load_curve(run_dp: str) -> dict[int, dict]:
    curve = {}
    for fp in glob.glob(os.path.join(run_dp, "results_step*.json")):
        m = re.search(r"results_step(\d+)\.json$", fp)
        if not m:
            continue
        with open(fp) as f:
            curve[int(m.group(1))] = json.load(f)
    final = os.path.join(run_dp, "results.json")
    if os.path.isfile(final):
        with open(final) as f:
            d = json.load(f)
        step = d.get("steps") or d.get("step")
        if step:
            curve[int(step)] = d
    return dict(sorted(curve.items()))


def crossing(curve: dict[int, dict], thresholds: dict) -> int | None:
    """Earliest step meeting ALL thresholds (psnr/miou/acc up, mae down)."""
    for step, r in curve.items():
        ok = (
            r.get("psnr", -1) >= thresholds["psnr"]
            and r.get("miou", -1) >= thresholds["miou"]
            and r.get("acc", -1) >= thresholds["acc"]
            and r.get("mae", 1e9) <= thresholds["mae"]
        )
        if ok:
            return step
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dps", nargs="+")
    # converged torch reference on the anchor scene, BEST seed at each
    # metric (3000 steps; docs/validation_run.md round-3 anchor table)
    ap.add_argument("--psnr", type=float, default=26.24)
    ap.add_argument("--miou", type=float, default=0.184)
    ap.add_argument("--acc", type=float, default=0.811)
    ap.add_argument("--mae", type=float, default=1.46)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument(
        "--rate-rays-s", type=float, default=0.0,
        help="train-only rays/s to convert steps->minutes; 0 = read "
             "train_rate_rays_s from each run's results.json",
    )
    ap.add_argument("--chips", type=int, default=8,
                    help="data-parallel projection divisor")
    args = ap.parse_args(argv)
    thresholds = {"psnr": args.psnr, "miou": args.miou,
                  "acc": args.acc, "mae": args.mae}
    print(f"thresholds (converged torch ref, best seed): {thresholds}")

    rows = []
    for run_dp in args.run_dps:
        curve = load_curve(run_dp)
        if not curve:
            print(f"{run_dp}: no curve results found", file=sys.stderr)
            continue
        step = crossing(curve, thresholds)
        mins = None
        if step is not None:
            # prefer the run's own measured training time at the crossing
            # horizon (written by ours_train_eval, the first launches
            # included, the curve evals excluded)
            secs = curve[step].get("train_seconds_to_here")
            if secs is not None:
                mins = secs / 60.0
            elif args.rate_rays_s:
                mins = step * args.batch / args.rate_rays_s / 60.0
        rows.append((os.path.basename(run_dp.rstrip("/")), step, mins))

    print(f"{'run':24} {'cross step':>10} "
          f"{'min (1 chip)':>12} {'min (x' + str(args.chips) + ')':>10}")
    for name, step, mins in rows:
        if step is None:
            print(f"{name:24} {'NOT CROSSED':>10}")
            continue
        m1 = f"{mins:.2f}" if mins is not None else "n/a"
        mn = f"{mins / args.chips:.2f}" if mins is not None else "n/a"
        print(f"{name:24} {step:>10} {m1:>12} {mn:>10}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
