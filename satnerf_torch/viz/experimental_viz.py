"""Experimental-regularizer visualizers.

ref: semantic/components/visualize.py:184-376 — the reference ships four
visualizer classes for its experimental DINO-feature / neighbour-smoothing /
density-regularization branches (``TensorboardDinoSummaryVisualization``,
``NeighbourmaskVisualization``, ``DepthsRegVisualization``,
``DensityRegVisualization``). No shipped reference pipeline instantiates
them (the regularizers themselves were dropped from the paper), but the
classes exist in the inventory, so functional equivalents live here.

They are key-gated: each returns ``None`` when the experimental results
keys (``dino``, ``neighbour_mask``, ``neighbours``, ``neighbour_mean_sigma``)
are absent, so they can sit in a visualizer suite harmlessly.

The reference's sklearn ``PCA`` / ``minmax_scale`` are replaced by a small
numpy SVD projection (sklearn is not a dependency of this package), and the
per-patch Python loop of the DINO average panel (ref: visualize.py:203-219)
is vectorized with ``np.add.at`` over the patch index map.
"""

from __future__ import annotations

import numpy as np

from satnerf_torch.viz.colormaps import apply_colormap, scale_for_tensorboard
from satnerf_torch.viz.visualize import SCALE_SMALL, ImageVisualization


def minmax_scale(x: np.ndarray) -> np.ndarray:
    """Column-wise rescale to [0, 1] (sklearn.preprocessing.minmax_scale)."""
    x = np.asarray(x, dtype=np.float32)
    lo = x.min(axis=0, keepdims=True)
    span = x.max(axis=0, keepdims=True) - lo
    return (x - lo) / np.where(span == 0, 1.0, span)


class FeaturePCA:
    """3-component PCA over feature vectors (stand-in for the reference
    dataset's sklearn ``dataset.pca``, ref: visualize.py:281-283)."""

    def __init__(self, n_components: int = 3):
        self.n_components = n_components
        self.mean_ = None
        self.components_ = None  # (n_components, F)

    def fit(self, features: np.ndarray) -> "FeaturePCA":
        feats = np.asarray(features, dtype=np.float32).reshape(
            -1, features.shape[-1]
        )
        self.mean_ = feats.mean(axis=0)
        # SVD of the centered matrix; right singular vectors = components.
        _, _, vt = np.linalg.svd(feats - self.mean_, full_matrices=False)
        self.components_ = vt[: self.n_components]
        return self

    def transform(self, features: np.ndarray) -> np.ndarray:
        feats = np.asarray(features, dtype=np.float32)
        return (feats - self.mean_) @ self.components_.T


def visualize_dino_features(pca, feats: np.ndarray, h: int | None = None,
                            w: int | None = None) -> np.ndarray:
    """Project (N, F) features to a uint8 RGB map (ref: visualize.py:274-297).

    Features wider than 3 channels are PCA-projected; 3-channel inputs in
    [0, 1] are passed through. Returns (h, w, 3) uint8 when h/w given,
    else (N, 3).
    """
    feats = np.asarray(feats)
    if feats.shape[-1] > 3:
        if pca is None:
            pca = FeaturePCA().fit(feats.reshape(-1, feats.shape[-1]))
        feats = minmax_scale(pca.transform(feats.reshape(-1, feats.shape[-1])))
    feats = np.asarray(feats, dtype=np.float32).reshape(-1, 3)
    if feats.max(initial=0.0) <= 1.2:
        feats = feats * 255.0
    out = feats.astype(np.uint8)
    if h is not None and w is not None:
        out = out.reshape(h, w, 3)
    return out


def _patch_average(values: np.ndarray, mapping: np.ndarray) -> np.ndarray:
    """Mean of ``values`` (N, F) within each patch id of ``mapping`` (N,),
    scattered back to per-pixel shape — vectorized replacement for the
    reference's per-patch loop (ref: visualize.py:203-219)."""
    mapping = np.asarray(mapping).reshape(-1).astype(np.int64)
    ids, inverse = np.unique(mapping, return_inverse=True)
    sums = np.zeros((len(ids), values.shape[-1]), dtype=np.float64)
    np.add.at(sums, inverse, values)
    counts = np.bincount(inverse, minlength=len(ids)).astype(np.float64)
    means = sums / counts[:, None]
    return means[inverse].astype(np.float32)


def _nearest_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbour resize of (H, W, C) (torchvision Resize stand-in)."""
    in_h, in_w = img.shape[:2]
    ys = np.clip((np.arange(out_h) * in_h / out_h).astype(np.int64), 0, in_h - 1)
    xs = np.clip((np.arange(out_w) * in_w / out_w).astype(np.int64), 0, in_w - 1)
    return img[ys][:, xs]


def _center_crop_or_pad(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """CenterCrop semantics incl. zero-padding when smaller (torchvision)."""
    in_h, in_w = img.shape[:2]
    out = np.zeros((out_h, out_w) + img.shape[2:], dtype=img.dtype)
    y0 = (in_h - out_h) // 2
    x0 = (in_w - out_w) // 2
    ys = slice(max(y0, 0), max(y0, 0) + min(in_h, out_h))
    xs = slice(max(x0, 0), max(x0, 0) + min(in_w, out_w))
    oy = slice(max(-y0, 0), max(-y0, 0) + min(in_h, out_h))
    ox = slice(max(-x0, 0), max(-x0, 0) + min(in_w, out_w))
    out[oy, ox] = img[ys, xs]
    return out


class TensorboardDinoSummaryVisualization(ImageVisualization):
    """gt / patch-averaged prediction / raw prediction DINO feature panel
    (ref: visualize.py:184-271). ``results["dino"]`` is (H*W, F) predicted
    features; ``sample`` carries the patch-grid ground truth (``dino``,
    ``dino_h``, ``dino_w``, ``dino_mapping``, ``dino_upscale``)."""

    def _visualize(self, dataset, sample, results, w, h):
        if "dino" not in results or "dino" not in sample:
            return None
        pca = getattr(dataset, "pca", None)

        pred = np.asarray(results["dino"], dtype=np.float32)  # (H*W, F)
        pred_img = visualize_dino_features(pca, minmax_scale(pred), h, w)

        averaged = minmax_scale(_patch_average(pred, sample["dino_mapping"]))
        avg_img = visualize_dino_features(pca, averaged, h, w)

        gh, gw = int(sample["dino_h"]), int(sample["dino_w"])
        gt = np.asarray(sample["dino"], dtype=np.float32).reshape(gh, gw, -1)
        gt_img = visualize_dino_features(pca, gt.reshape(gh * gw, -1), gh, gw)
        # undo the 14x14 ViT patching: upsample by 14/upscale, then
        # center-crop/pad to the (possibly unpadded) RGB size.
        upscale = int(sample.get("dino_upscale", 1))
        if 14 % upscale == 0:
            rep = 14 // upscale
            gt_img = np.repeat(np.repeat(gt_img, rep, axis=0), rep, axis=1)
        else:
            gt_img = _nearest_resize(
                gt_img, int(gh * 14 / upscale), int(gw * 14 / upscale)
            )
        gt_img = _center_crop_or_pad(gt_img, h, w)

        panels = [gt_img, avg_img, pred_img]  # each (H, W, 3) uint8
        panels = [
            scale_for_tensorboard(
                np.moveaxis(p, -1, 0).astype(np.float32) / 255.0, SCALE_SMALL
            )
            for p in panels
        ]
        return np.stack(panels)

    def _name(self):
        return "dino_summary"


class NeighbourmaskVisualization(ImageVisualization):
    """Binary map of rays with active neighbour smoothing
    (ref: visualize.py:300-311)."""

    def _visualize(self, dataset, sample, results, w, h):
        if "neighbour_mask" not in results:
            return None
        mask = np.asarray(results["neighbour_mask"]).reshape(h, w)
        return mask.astype(np.float32)

    def _name(self):
        return "neighbour_smoothing_mask"


class DepthsRegVisualization(ImageVisualization):
    """Squared deviation of each ray's depth from its neighbours' mean,
    scattered onto the masked pixels (ref: visualize.py:314-334)."""

    def _visualize(self, dataset, sample, results, w, h):
        if "neighbours" not in results or "neighbour_mask" not in results:
            return None
        depths = np.asarray(results["neighbours"], dtype=np.float32)  # (N, K)
        diff = np.square(np.abs(depths[:, 0] - depths[:, 1:].mean(axis=-1)))
        image = np.zeros(h * w, dtype=np.float32)
        mask = np.asarray(results["neighbour_mask"]).reshape(-1).astype(bool)
        image[mask] = diff
        return image.reshape(h, w)

    def _name(self):
        return "depths_reg"


class DensityRegVisualization(ImageVisualization):
    """Squared main-vs-neighbour-mean sigma difference on the pixels whose
    predicted class is in ``apply_to_labels`` (ref: visualize.py:337-376).
    ``results["neighbour_mean_sigma"]`` is (H*W, 3):
    [mean sigma, main sigma, neighbour-valid flag]."""

    def __init__(self, cfg, send_to_tensorboard=True, save_as_tif=False,
                 apply_to_labels=(0, 1)):
        super().__init__(cfg, send_to_tensorboard, save_as_tif)
        self.apply_to_labels = np.asarray(apply_to_labels, dtype=np.int64)

    def _visualize(self, dataset, sample, results, w, h):
        if "neighbour_mean_sigma" not in results:
            return None
        ms = np.asarray(results["neighbour_mean_sigma"], dtype=np.float32)
        mean_sigma, main_sigma = ms[:, 0], ms[:, 1]
        neighbour_mask = ms[:, 2].astype(bool)

        difference = np.square(np.abs(mean_sigma - main_sigma))
        labels = np.asarray(results["semantic_label"]).reshape(-1)
        mask = np.isin(labels, self.apply_to_labels) & neighbour_mask
        difference = np.where(mask, difference, 0.0).reshape(h, w)

        panels = [
            np.moveaxis(apply_colormap(difference), -1, 0),
            np.moveaxis(
                apply_colormap(mask.reshape(h, w).astype(np.float32)), -1, 0
            ),
        ]
        return np.stack(
            [scale_for_tensorboard(p, SCALE_SMALL) for p in panels]
        )

    def _name(self):
        return "density_reg"
