"""Semantic metrics: per-pixel accuracy, mIoU, confusion matrix and
uncertainty-at-transient (port of ``satnerf_tpu/eval/semantic_metrics.py``,
numpy).

Accuracy counts any |gt - pred| > 0 as an error (optionally not at a
filtered class), mIoU uses the Semantic-NeRF confusion-matrix formula,
confusion matrices are row-normalised ("true"), and uncertainty at transient
averages the composited beta over rays whose label is "car".

``render_confusion_matrix_png`` draws the matrix in numpy: one square block
per (true, predicted) class pair, coloured on matplotlib's "Blues" ramp with
vmin 0 and vmax 1. The JAX package draws a matplotlib figure with axis
labels, a colour bar and the values as text; this one carries no text (the
values stay in results.json), so the port needs no matplotlib.
"""

from __future__ import annotations

import numpy as np

# matplotlib's "Blues" (ColorBrewer), nine anchors as 8-bit RGB
_BLUES = np.array([[247, 251, 255], [222, 235, 247], [198, 219, 239], [158, 202, 225],
                   [107, 174, 214], [66, 146, 198], [33, 113, 181], [8, 81, 156],
                   [8, 48, 107]], np.float64) / 255.0
CELL_PX = 32  # side of one class pair's block in the figure


def semantic_error(pred, gt, filter_idx: int | None = None) -> np.ndarray:
    pred = np.asarray(pred).reshape(-1)
    gt = np.asarray(gt).reshape(-1)
    err = np.clip(np.abs(gt.astype(np.int64) - pred.astype(np.int64)), 0, 1)
    if filter_idx is not None:
        err[gt == filter_idx] = 0
    return err


def semantic_accuracy(pred, gt, filter_idx: int | None = None) -> float:
    err = semantic_error(pred, gt, filter_idx)
    return float(1.0 - err.sum() / err.size)


def confusion_matrix(pred, gt, n_classes: int, normalize: str = "true") -> np.ndarray:
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    gt = np.asarray(gt).reshape(-1).astype(np.int64)
    cm = np.zeros((n_classes, n_classes), dtype=np.float64)
    np.add.at(cm, (gt, pred), 1.0)
    if normalize == "true":
        row = cm.sum(axis=1, keepdims=True)
        cm = np.divide(cm, row, out=np.zeros_like(cm), where=row > 0)
    return cm


def per_class_iou(confusion_matrix_values: np.ndarray) -> np.ndarray:
    """IoU per class from a confusion matrix (nan for absent classes)."""
    cm = np.asarray(confusion_matrix_values, dtype=np.float64)
    n = cm.shape[0]
    ious = np.zeros(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        for c in range(n):
            denom = cm[c, :].sum() + cm[:, c].sum() - cm[c, c]
            ious[c] = cm[c, c] / denom if denom > 0 else np.nan
    return ious


def semantic_miou(confusion_matrix_values: np.ndarray) -> float:
    """Semantic-NeRF mIoU from a confusion matrix."""
    return float(np.nanmean(per_class_iou(confusion_matrix_values)))


def uncertainty_at_transient(results: dict, semantic_gt, car_idx: int) -> float:
    """Mean composited beta over rays whose GT label is 'car'."""
    beta = np.asarray(results["beta"])  # (N, S, 1)
    weights = np.asarray(results["weights"])  # (N, S)
    composited = (weights[..., None] * beta).sum(axis=-2)[:, 0]
    mask = np.asarray(semantic_gt).reshape(-1) == car_idx
    if mask.sum() == 0:
        return float("nan")
    return float(composited[mask].sum() / mask.sum())


def blues(x) -> np.ndarray:
    """Values in [0, 1] -> (..., 3) uint8 on the "Blues" ramp, sampled as
    matplotlib samples it (a 256-entry table, truncated to 8 bits)."""
    lut = np.stack([np.interp(np.linspace(0.0, 1.0, 256), np.linspace(0.0, 1.0, 9),
                              _BLUES[:, k]) for k in range(3)], axis=1)
    idx = np.clip((np.nan_to_num(np.asarray(x, np.float64)) * 256).astype(np.int64), 0, 255)
    return (lut[idx] * 255).astype(np.uint8)


def render_confusion_matrix_png(cm: np.ndarray, labels: list[str]) -> np.ndarray:
    """The confusion matrix as a (3, H, W) uint8 image: row i (true class)
    and column j (predicted class) fill one CELL_PX block coloured by
    cm[i, j] in [0, 1]. ``labels`` names the classes in order; the image
    carries no text."""
    cm = np.asarray(cm, np.float64)
    if cm.shape != (len(labels), len(labels)):
        raise ValueError(f"a {cm.shape} confusion matrix for {len(labels)} classes")
    img = np.repeat(np.repeat(blues(cm), CELL_PX, axis=0), CELL_PX, axis=1)
    return np.moveaxis(img, -1, 0)
