"""Eval-time sine-engine swap: render the same checkpoint under several sine
engines and print PSNR, SSIM and the registered DSM MAE per engine (port of
the JAX package's ``tools/sin_swap_eval.py``).

Training with the degree-5 sine (``sin_impl="poly5"``) costs DSM MAE in the
JAX package's paired-seed runs. Two mechanisms are possible: a forward bias
(the engine's error perturbs density and depth at inference, so swapping
the engine at eval time changes the MAE) or a training bias (the weights
adapt around the engine's error, so the eval-time engine barely matters).
Running this tool over {poly-trained, poly5-trained} runs fills the matrix
that tells them apart.

Engines: ``poly``, ``poly5`` and ``poly7f`` render through the fused field
kernel K1 under that ``SinMode`` (``csrc/sine.cuh``, ``ops/fastmath.py``);
``exact`` (``torch.sin``) renders through the plain layer-by-layer field, as
the JAX package renders it through XLA and not through its Pallas kernel.
Each row carries the K1 launches its renders made under the row's
``SinMode`` and their plain field calls.

Usage:
  python -m satnerf_torch.tools.sin_swap_eval <run_dp> [...run_dps]
      [--sins poly,poly5,poly7f,exact] [--split test] [--out DIR] [--device cuda|cpu]

``--out`` defaults to ``<tmp>/sinswap``; ``--device`` to ``cuda`` (raises
without a GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from dataclasses import replace

import numpy as np


def eval_loaded_with_sin(loaded, sin: str, split: str, out_dp: str, device) -> dict:
    """``loaded`` = ``eval.loader.load_run``'s (pipeline, params, rcfg, step):
    every image of ``split`` rendered with the field's sine swapped to
    ``sin`` -> mean psnr, ssim and mae, the renders' K1 launches under that
    engine's ``SinMode`` (``ops/field_fused.py:LAUNCHES_BY_SIN``) and their
    plain field calls."""
    from satnerf_torch.eval.eval_nerf import evaluate_image
    from satnerf_torch.models import field as field_mod
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.render.renderer import render_image_chunked

    pipeline, params, rcfg, step = loaded
    rcfg = replace(rcfg, field=replace(rcfg.field, sin_impl=sin))
    dataset = pipeline.datasets["rgb" if split == "train" else "rgb_test"]
    start = 1 if split == "test" else 0
    os.makedirs(out_dp, exist_ok=True)

    agg: dict = {}
    launches0 = dict(ff.LAUNCHES_BY_SIN)
    plain0 = field_mod.PLAIN_CALLS
    for img_idx in range(start, len(dataset.data)):
        img = dataset.image_item(img_idx)
        res = render_image_chunked(params, rcfg, img["rays"], img["extras"], chunk=16384,
                                   device=device)
        entry = evaluate_image(dataset, img, res, out_dp, step)
        for k in ("psnr", "ssim"):
            agg.setdefault(k, []).append(float(entry[k]))
        mae = entry.get("mae", {})
        if isinstance(mae, dict) and mae.get("mean") not in (None, "nan"):
            agg.setdefault("mae", []).append(float(mae["mean"]))
    out = {k: float(np.mean(v)) for k, v in agg.items()}
    out["field_kernel_launches"] = ff.LAUNCHES_BY_SIN.get(sin, 0) - launches0.get(sin, 0)
    out["plain_field_calls"] = field_mod.PLAIN_CALLS - plain0
    return out


def _label(run_dp: str) -> str:
    """Run dirs sit under <harness-out>/training/<stamp>_...: the label is the
    harness out-dir's name (it encodes the trained engine and seed)."""
    name = os.path.basename(run_dp.rstrip("/"))
    parent_dp = os.path.dirname(run_dp.rstrip("/"))
    parent = os.path.basename(parent_dp)
    if parent == "training":
        return os.path.basename(os.path.dirname(parent_dp))
    if parent.startswith("training_"):
        return parent
    return name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dps", nargs="+")
    ap.add_argument("--sins", default="poly,poly5")
    ap.add_argument("--split", default="test")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sinswap"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from satnerf_torch.device import resolve_device
    from satnerf_torch.eval.loader import load_run

    dev = resolve_device(args.device)
    rows = []
    for run_dp in args.run_dps:
        label = _label(run_dp)
        loaded = load_run(run_dp, -1, device=dev)  # one restore for every engine
        for sin in args.sins.split(","):
            out_dp = os.path.join(args.out, f"{label}__{sin}")
            row = {"run": label, "eval_sin": sin,
                   **eval_loaded_with_sin(loaded, sin, args.split, out_dp, dev)}
            rows.append(row)
            print("SINSWAP " + json.dumps(row), flush=True)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(rows, f, indent=2)
    print(f"summary -> {args.out}/summary.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
