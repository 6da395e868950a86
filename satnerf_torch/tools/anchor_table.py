"""Render the trained-vs-trained learning-curve table: the port beside the
JAX package (a copy of the JAX package's ``tools/anchor_table.py``; it reads
JSON only).

Both sides are run directories of the same eval JSONs
(``results_step{N}.json`` at the curve horizons plus a final
``results.json``): ``--ours`` those of ``satnerf_torch.tools.ours_train_eval
--eval-at``, ``--ref`` those of the JAX package's ``tools/ours_train_eval.py
--eval-at``, so one table shows the port beside the JAX package.

Usage:
    python -m satnerf_torch.tools.anchor_table <root> --ours ours_s0,ours_s1,ours_s2 \
        --ref ref_s0,ref_s1 --steps 1000,2000,3000
"""

from __future__ import annotations

import argparse
import json
import os
import sys

METRICS = [("psnr", "PSNR", 2, True), ("mae", "DSM-MAE (m)", 3, False),
           ("acc", "sem acc", 3, True), ("miou", "mIoU", 3, True)]


def load(root: str, run: str, step: int, final_steps: int):
    path = os.path.join(root, run, f"results_step{step}.json")
    if not os.path.isfile(path) and step == final_steps:
        path = os.path.join(root, run, "results.json")
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        r = json.load(fh)
    return {k: v for k, v in r.items() if isinstance(v, (int, float))}


def fmt_range(vals, nd):
    lo, hi = min(vals), max(vals)
    if len(vals) == 1:
        return f"{lo:.{nd}f}"
    return f"{lo:.{nd}f}–{hi:.{nd}f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--ours", default="ours_s0,ours_s1,ours_s2")
    ap.add_argument("--ref", default="ref_s0,ref_s1")
    ap.add_argument("--steps", default="1000,2000,3000")
    args = ap.parse_args(argv)

    steps = [int(s) for s in args.steps.split(",")]
    final = steps[-1]
    sides = {"ours (satnerf_torch)": args.ours.split(","),
             "reference (satnerf_tpu)": args.ref.split(",")}

    print("| step | side | " + " | ".join(m[1] for m in METRICS) + " |")
    print("|---|---|" + "---|" * len(METRICS))
    ok = True
    for step in steps:
        for side, runs in sides.items():
            rows = []
            for run in runs:
                r = load(args.root, run, step, final)
                if r is None:
                    print(f"MISSING {run} step {step}", file=sys.stderr)
                    ok = False
                    continue
                rows.append(r)
            if not rows:
                continue
            cells = [fmt_range([r[k] for r in rows], nd) for k, _, nd, _ in METRICS]
            n = len(rows)
            print(f"| {step} | {side} (n={n}) | " + " | ".join(cells) + " |")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
