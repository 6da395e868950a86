"""Both packages' image consumers on one render: does the evaluation read a
render of the port as the JAX package's evaluation reads it?

    env JAX_PLATFORMS=cpu python tests/torch_render_check.py <render.npz> <run_dp> [out_dp]

``<render.npz>`` is a render that ``rung_audit.py --render-at`` saved (the
per-ray outputs of ``render_image_chunked`` for the first test view and beta
composited along each ray, with its ``name`` and ``step``); ``<run_dp>`` holds that run's ``configs/``, and its
scene must exist where those configs point (``generate_scene`` makes it
again, deterministically). Each package loads the run's datasets and feeds
the same arrays to its ``evaluate_image`` (PSNR, SSIM, the DSM and its MAE)
and ``evaluate_semantic_image``; the last line is one JSON object with both
packages' values and their largest difference.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

KEYS = ("psnr", "ssim", "mae", "mae_median", "semantic_accuracy", "mIoU",
        "uncertainty_at_transient")


def evaluate(pkg: str, run_dp: str, res: dict, name: str, step: int, out_dp: str) -> dict:
    """``pkg``'s evaluate_image and evaluate_semantic_image on ``res``."""
    configs = importlib.import_module(f"{pkg}.configs")
    pipelines = importlib.import_module(f"{pkg}.pipelines")
    nerf = importlib.import_module(f"{pkg}.eval.eval_nerf")
    sem = importlib.import_module(f"{pkg}.eval.eval_semantic")
    pipeline = pipelines.load_pipeline(configs.load_configs_from_logs(run_dp))
    pipeline.load_datasets()
    test = pipeline.datasets["rgb_test"]
    index = [test.image_item(i)["name"] for i in range(len(test.data))].index(name)
    img = test.image_item(index)
    dp = os.path.join(out_dp, pkg)
    os.makedirs(dp, exist_ok=True)
    got = nerf.evaluate_image(test, img, res, dp, step)
    if "beta" not in res:  # a render saved without beta: no uncertainty at cars
        sem.uncertainty_at_transient = lambda *a: float("nan")
    entry, _ = sem.evaluate_semantic_image(test, img, res, dp, False)
    return {"psnr": float(got["psnr"]), "ssim": float(got["ssim"]),
            "mae": float(got["mae"]["mean"]), "mae_median": float(got["mae"]["median"]),
            **{k: float(entry[k]) for k in KEYS[4:]}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 1
    npz_fp, run_dp = argv[:2]
    out_dp = argv[2] if len(argv) > 2 else os.path.join(os.path.dirname(npz_fp), "render_check")
    saved = np.load(npz_fp)
    meta = ("name", "step", "h", "w")
    res = {k: saved[k] for k in saved.files if k not in meta}
    if "semantic_label" not in res:  # the renderer's own labels
        res["semantic_label"] = res["semantic_logits"].argmax(-1)
    if "beta_composited" in res:  # one sample of weight 1 composites to it
        beta = res.pop("beta_composited")
        res["beta"], res["weights"] = beta[:, None, None], np.ones((len(beta), 1), np.float32)
    name, step = str(saved["name"]), int(saved["step"])
    out = {pkg: evaluate(pkg, run_dp, res, name, step, out_dp)
           for pkg in ("satnerf_tpu", "satnerf_torch")}
    out["max_abs_diff"] = max(abs(out["satnerf_tpu"][k] - out["satnerf_torch"][k])
                              for k in KEYS if np.isfinite(out["satnerf_tpu"][k]))
    out.update(image=name, step=step)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
