"""Offline semantic evaluation: accuracy (also without cars and against
clean labels), mIoU, per-image and split confusion matrices,
uncertainty at transient (port of ``satnerf_tpu/eval/eval_semantic.py``;
the same results.json display keys).

CLI: python -m satnerf_torch.eval.eval_semantic <run_or_experiment_dp>
     [output_dp] [--split test|train] [--epoch N] [--chunk N] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from satnerf_torch.device import resolve_device
from satnerf_torch.eval.loader import load_run
from satnerf_torch.eval.semantic_metrics import (
    confusion_matrix,
    per_class_iou,
    render_confusion_matrix_png,
    semantic_accuracy,
    uncertainty_at_transient,
)
from satnerf_torch.eval.util import run_eval_script
from satnerf_torch.io.png import save_png
from satnerf_torch.logger import logger
from satnerf_torch.render.renderer import render_image_chunked

_DISPLAY = {
    "semantic_accuracy": "Semantic Accuracy (Mean)",
    "semantic_accuracy_wo_cars": "Semantic Accuracy with no cars (Mean)",
    "mIoU": "mIoU (Mean)",
    "semantic_accuracy_comparison_non_corrupted": "Semantic Accuracy comparison to GT (Mean)",
    "semantic_accuracy_comparison_non_corrupted_wo_cars":
        "Semantic Accuracy comparison to GT w/o cars (Mean)",
    "uncertainty_at_transient": "Uncertainty at transient (Mean)",
    "semantic_accuracy_coarse": "Semantic Accuracy coarse (Mean)",
    "mIoU_coarse": "mIoU coarse (Mean)",
}


def eval_semantic_nerfs(input_dp: str, output_dp: str, split: str = "test", epoch: int = -1,
                        chunk: int = 16384, device=None):
    if not os.path.isdir(input_dp):
        raise FileNotFoundError(f"not a run dir: {input_dp}")
    dev = resolve_device(device)
    pipeline, params, rcfg, step = load_run(input_dp, epoch, device=dev)

    run_name = os.path.basename(input_dp.rstrip("/"))
    output_dp = os.path.join(output_dp, run_name, "eval_semantic", split)
    os.makedirs(output_dp, exist_ok=True)

    dataset = pipeline.datasets["rgb" if split == "train" else "rgb_test"]
    labels = list(dataset.semantic_cls_labels.values())
    n_classes = dataset.semantic_n_classes
    corrupted = "corrupted" in pipeline.cfg.pipeline.semantic_dataset_type
    start = 1 if split == "test" else 0

    all_results: dict = {}
    cm_split = np.zeros((n_classes, n_classes))
    for img_idx in range(start, len(dataset.data)):
        img = dataset.image_item(img_idx)
        res = render_image_chunked(params, rcfg, img["rays"], img["extras"], chunk=chunk,
                                   device=dev)
        entry, cm_raw = evaluate_semantic_image(dataset, img, res, output_dp, corrupted)
        cm_split += cm_raw
        all_results[img["name"]] = entry

    write_semantic_results(all_results, cm_split, labels, output_dp)
    return all_results


def evaluate_semantic_image(dataset, img: dict, res: dict, output_dp: str, corrupted: bool):
    """Semantic metrics for one rendered image (shared with eval_all)."""
    labels = list(dataset.semantic_cls_labels.values())
    n_classes = dataset.semantic_n_classes
    pred = res["semantic_label"]
    gt = img["semantic"]

    cm_raw = confusion_matrix(pred, gt, n_classes, normalize=None)
    cm_img = confusion_matrix(pred, gt, n_classes, normalize="true")
    _save_png(render_confusion_matrix_png(cm_img, labels),
              os.path.join(output_dp, img["name"] + ".png"))

    ious = per_class_iou(cm_img)
    entry = {
        "semantic_accuracy": semantic_accuracy(pred, gt),
        "mIoU": float(np.nanmean(ious)),
        "per_class_iou": {
            name: (None if np.isnan(ious[i]) else round(float(ious[i]), 4))
            for i, name in enumerate(labels)
        },
        "uncertainty_at_transient": uncertainty_at_transient(res, gt, dataset.car_cls_idx),
        "confusion_matrix": cm_img.tolist(),
    }
    if "semantic_no_cars" in img:
        entry["semantic_accuracy_wo_cars"] = semantic_accuracy(pred, img["semantic_no_cars"])
    if "semantic_label_coarse" in res:
        # hierarchical runs also score the coarse pass ("<metric>_coarse")
        pred_c = res["semantic_label_coarse"]
        entry["semantic_accuracy_coarse"] = semantic_accuracy(pred_c, gt)
        cm_c = confusion_matrix(pred_c, gt, n_classes, normalize="true")
        entry["mIoU_coarse"] = float(np.nanmean(per_class_iou(cm_c)))
    if corrupted:
        clean = img["semantic_non_corrupted"]
        entry["semantic_accuracy_comparison_non_corrupted"] = semantic_accuracy(pred, clean)
        entry["semantic_accuracy_comparison_non_corrupted_wo_cars"] = semantic_accuracy(
            pred, clean, filter_idx=dataset.car_cls_idx)
    logger.info("Eval", f"{img['name']}: acc={entry['semantic_accuracy']:.4f} "
                        f"mIoU={entry['mIoU']:.4f}")
    return entry, cm_raw


def write_semantic_results(all_results, cm_split, labels, output_dp):
    d = dict(all_results)
    for key, display in _DISPLAY.items():
        vals = [v[key] for v in all_results.values() if key in v]
        if vals:
            d[display] = "{:.4f}".format(float(np.nanmean(vals)))

    row = cm_split.sum(axis=1, keepdims=True)
    cm_norm = np.divide(cm_split, row, out=np.zeros_like(cm_split), where=row > 0)
    d["confusion_matrix"] = cm_norm.tolist()
    _save_png(render_confusion_matrix_png(cm_norm, labels), os.path.join(output_dp, "mean.png"))
    with open(os.path.join(output_dp, "results.json"), "w") as f:
        json.dump(d, f, indent=4)
    logger.info("Eval", f"results written to {output_dp}/results.json")


def _save_png(chw: np.ndarray, fp: str):
    save_png(np.moveaxis(chw, 0, -1), fp)


def main(argv=None):
    from satnerf_torch.eval.eval_nerf import _parse

    argv = argv if argv is not None else sys.argv[1:]
    args, kwargs = _parse(argv)
    run_eval_script(eval_semantic_nerfs, *args, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
