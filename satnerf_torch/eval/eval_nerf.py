"""Offline NeRF evaluation: per-image PSNR / SSIM / registered altitude MAE
(port of ``satnerf_tpu/eval/eval_nerf.py``; the same results.json layout:
per-image entries plus "MAE (Mean)", "MAE (Median)", "PSNR (Mean)" and
"SSIM (Mean)").

CLI: python -m satnerf_torch.eval.eval_nerf <run_or_experiment_dp> [output_dp]
     [--split test|train] [--epoch N] [--chunk N] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys

from satnerf_torch.device import resolve_device
from satnerf_torch.eval import metrics
from satnerf_torch.eval.dsm import compute_dsm_and_mae
from satnerf_torch.eval.loader import load_run
from satnerf_torch.eval.util import run_eval_script
from satnerf_torch.logger import logger
from satnerf_torch.render.renderer import render_image_chunked


def eval_nerf_training(input_dp: str, output_dp: str, split: str = "test", epoch: int = -1,
                       chunk: int = 16384, device=None):
    if not os.path.isdir(input_dp):
        raise FileNotFoundError(f"not a run dir: {input_dp}")
    dev = resolve_device(device)
    pipeline, params, rcfg, step = load_run(input_dp, epoch, device=dev)

    run_name = os.path.basename(input_dp.rstrip("/"))
    output_dp = os.path.join(output_dp, run_name, "eval", split)
    os.makedirs(output_dp, exist_ok=True)

    dataset = pipeline.datasets["rgb" if split == "train" else "rgb_test"]
    start = 1 if split == "test" else 0  # skip the prepended train view

    all_results: dict = {}
    for img_idx in range(start, len(dataset.data)):
        img = dataset.image_item(img_idx)
        res = render_image_chunked(params, rcfg, img["rays"], img["extras"], chunk=chunk,
                                   device=dev)
        all_results[img["name"]] = evaluate_image(dataset, img, res, output_dp, step)
        with open(os.path.join(output_dp, "results.json"), "w") as f:
            json.dump(_with_running_means(all_results), f, indent=4)

    logger.info("Eval", f"results written to {output_dp}/results.json")
    return all_results


def evaluate_image(dataset, img: dict, res: dict, output_dp: str, step: int) -> dict:
    """PSNR/SSIM/MAE for one rendered image (shared with eval.eval_all,
    which renders each image once for all consumers)."""
    h, w = img["h"], img["w"]
    gt = img["rgbs"].reshape(h, w, 3)
    pred = res["rgb"].reshape(h, w, 3)

    mae = compute_dsm_and_mae(dataset, img["rays"], res["depth"], output_dp, img["name"], step)
    psnr_ = float(metrics.psnr(pred, gt))
    ssim_ = float(metrics.ssim(pred, gt))
    logger.info("Eval", f"{img['name']}: psnr={psnr_:.2f} ssim={ssim_:.3f} mae={mae['mean']}")
    out = {"mae": mae, "psnr": f"{psnr_:.2f}", "ssim": f"{ssim_:.3f}"}
    if "rgb_coarse" in res:
        # hierarchical runs report both passes, with the reference's
        # "_coarse" suffix (framework/components/rendering.py:119)
        pc = res["rgb_coarse"].reshape(h, w, 3)
        out["psnr_coarse"] = f"{float(metrics.psnr(pc, gt)):.2f}"
        out["ssim_coarse"] = f"{float(metrics.ssim(pc, gt)):.3f}"
    return out


def _with_running_means(all_results: dict) -> dict:
    mae_mean = mae_median = psnr_mean = ssim_mean = 0.0
    for v in all_results.values():
        mae_mean += float(v["mae"]["mean"])
        mae_median += float(v["mae"]["median"])
        psnr_mean += float(v["psnr"])
        ssim_mean += float(v["ssim"])
    n = max(len(all_results), 1)
    d = dict(all_results)
    d["MAE (Mean)"] = f"{mae_mean / n:.3f}"
    d["MAE (Median)"] = f"{mae_median / n:.3f}"
    d["PSNR (Mean)"] = f"{psnr_mean / n:.2f}"
    d["SSIM (Mean)"] = f"{ssim_mean / n:.3f}"
    return d


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    args, kwargs = _parse(argv)
    run_eval_script(eval_nerf_training, *args, **kwargs)
    return 0


def _parse(argv):
    """argv -> (positional, kwargs) with numeric/bool value coercion."""
    def coerce(v: str):
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                continue
        return v

    args, kwargs = [], {}
    it = iter(argv)
    for a in it:
        if a.startswith("--"):
            kwargs[a[2:].replace("-", "_")] = coerce(next(it))
        else:
            args.append(a)
    return args, kwargs


if __name__ == "__main__":
    raise SystemExit(main())
