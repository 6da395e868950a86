"""Semantic visualizers (ref: semantic/components/visualize.py:30-376),
including the paper's shaded semantic 3D rendering (class colors modulated by
the composited sun lighting scalar)."""

from __future__ import annotations

import numpy as np

from satnerf_torch.data_prep.prepare_annotations import (
    get_semantic_class_color_mapping,
)
from satnerf_torch.eval.semantic_metrics import (
    confusion_matrix,
    render_confusion_matrix_png,
    semantic_error,
)
from satnerf_torch.viz.colormaps import apply_colormap, scale_for_tensorboard
from satnerf_torch.viz.visualize import SCALE_SMALL, ImageVisualization


def _labels_to_colors(labels_hw: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (3, H, W) uint8 class-color image."""
    colors = get_semantic_class_color_mapping()
    mapped = colors[np.clip(labels_hw.astype(np.int64), 0, len(colors) - 1)]
    return np.moveaxis(mapped, -1, 0)


class SemanticColorVisualization(ImageVisualization):
    def _visualize(self, dataset, sample, results, w, h):
        return _labels_to_colors(results["semantic_label"].reshape(h, w))

    def _name(self):
        return "semantic_rendering"


class SemanticColorShadingVisualization(ImageVisualization):
    """Class colors x composited sun scalar — the paper's lighting-scalar
    semantic 3D visualization (ref: visualize.py:136-160)."""

    def _visualize(self, dataset, sample, results, w, h):
        colors = _labels_to_colors(results["semantic_label"].reshape(h, w))
        sun = np.asarray(results["sun"])  # (N, S, 1)
        weights = np.asarray(results["weights"])  # (N, S)
        shading = (weights[..., None] * sun).sum(axis=-2).reshape(h, w)
        return (colors * shading[None]).astype(np.uint8)

    def _name(self):
        return "semantic_rendering_shaded"


class SemanticErrorVisualization(ImageVisualization):
    def _visualize(self, dataset, sample, results, w, h):
        err = semantic_error(
            results["semantic_label"].reshape(-1), sample["semantic"].reshape(-1)
        )
        return err.reshape(h, w).astype(np.float32)

    def _name(self):
        return "semantic_error"


class TensorboardSemanticSummaryVisualization(ImageVisualization):
    """gt / prediction / error panel stack (+ clean-GT comparison variant)."""

    def __init__(self, cfg, send_to_tensorboard, save_as_tif,
                 compare_non_corrupted: bool = False):
        super().__init__(cfg, send_to_tensorboard, save_as_tif)
        self.compare_non_corrupted = compare_non_corrupted

    def _visualize(self, dataset, sample, results, w, h):
        gt_key = (
            "semantic_non_corrupted" if self.compare_non_corrupted else "semantic"
        )
        if gt_key not in sample:
            return None
        pred = results["semantic_label"].reshape(h, w)
        gt = sample[gt_key].reshape(h, w)
        err = semantic_error(pred, gt).reshape(h, w)
        panels = [
            _labels_to_colors(gt).astype(np.float32) / 255.0,
            _labels_to_colors(pred).astype(np.float32) / 255.0,
            np.moveaxis(apply_colormap(err.astype(np.float32)), -1, 0),
        ]
        return np.stack([scale_for_tensorboard(p, SCALE_SMALL) for p in panels])

    def _name(self):
        name = "semantic_summary"
        if self.compare_non_corrupted:
            name += "_non_corrupted"
        return name


class TensorboardSemanticClassVisualization(ImageVisualization):
    """Per-class composited logit maps (ref: visualize.py:87-115)."""

    def _visualize(self, dataset, sample, results, w, h):
        logits = np.asarray(results["semantic_logits"]).reshape(h, w, -1)
        panels = []
        for c in range(logits.shape[-1]):
            img = np.moveaxis(apply_colormap(logits[:, :, c]), -1, 0)
            panels.append(scale_for_tensorboard(img, SCALE_SMALL))
        return np.stack(panels)

    def _name(self):
        return "semantic_class_overview"


class ConfusionMatrixVisualization(ImageVisualization):
    def _visualize(self, dataset, sample, results, w, h):
        labels = list(dataset.semantic_cls_labels.values())
        cm = confusion_matrix(
            results["semantic_label"], sample["semantic"], len(labels)
        )
        png = render_confusion_matrix_png(cm, labels)
        return png.astype(np.float32) / 255.0

    def _name(self):
        return "confusion_matrix"
