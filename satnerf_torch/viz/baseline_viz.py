"""Baseline visualizers (ref: baseline/components/visualize.py:22-150)."""

from __future__ import annotations

import numpy as np

from satnerf_torch.viz.colormaps import apply_colormap, scale_for_tensorboard
from satnerf_torch.viz.visualize import SCALE_SMALL, ImageVisualization


class TensorboardSummaryVisualization(ImageVisualization):
    """gt / prediction / depth panel stack."""

    def _visualize(self, dataset, sample, results, w, h):
        pred = np.moveaxis(results["rgb"].reshape(h, w, 3), -1, 0)
        gt = np.moveaxis(sample["rgbs"].reshape(h, w, 3), -1, 0)
        depth = np.moveaxis(apply_colormap(results["depth"].reshape(h, w)), -1, 0)
        stack = [
            scale_for_tensorboard(img, SCALE_SMALL) for img in (gt, pred, depth)
        ]
        return np.stack(stack)

    def _name(self):
        return "gt_pred_depth"


class AltsVisualization(ImageVisualization):
    """Altitude map via back-projection (jet colormap)."""

    def _visualize(self, dataset, sample, results, w, h):
        _, _, alts = dataset.get_latlonalt_from_nerf_prediction(
            sample["rays"], results["depth"]
        )
        return np.asarray(alts).reshape(h, w)

    def _name(self):
        return "alts"

    def _colormap(self):
        return "jet"


class FactorVisualization(ImageVisualization):
    """Weighted factor maps: rgb/depth/albedo/sun/beta/irradiance/sky."""

    def __init__(self, cfg, send_to_tensorboard, save_as_tif, factor_name,
                 viz_name=None, cmap="bone"):
        super().__init__(cfg, send_to_tensorboard, save_as_tif)
        self.factor_name = factor_name
        self.viz_name = viz_name or factor_name
        self.cmap = cmap

    def _visualize(self, dataset, sample, results, w, h):
        if self.factor_name not in results:
            return None
        factor = np.asarray(results[self.factor_name])
        weights = np.asarray(results["weights"])
        if factor.ndim == 3:  # per-sample factor -> composite with weights
            comp = (weights[..., None] * factor).sum(axis=-2)
            if comp.shape[-1] == 3:
                return np.moveaxis(comp.reshape(h, w, 3), -1, 0)
            return comp.reshape(h, w)
        if factor.ndim == 2 and factor.shape[-1] == 3:
            return np.moveaxis(factor.reshape(h, w, 3), -1, 0)
        return factor.reshape(h, w)

    def _name(self):
        return self.viz_name

    def _colormap(self):
        return self.cmap


class RGBDiffVisualization(ImageVisualization):
    def _visualize(self, dataset, sample, results, w, h):
        pred = results["rgb"].reshape(h, w, 3)
        gt = sample["rgbs"].reshape(h, w, 3)
        return np.moveaxis(np.abs(gt - pred), -1, 0)

    def _name(self):
        return "RGB_Diff"


class RGBDiffDistanceVisualization(RGBDiffVisualization):
    def _visualize(self, dataset, sample, results, w, h):
        diff = super()._visualize(dataset, sample, results, w, h)
        return np.sqrt(np.square(diff).sum(axis=0))

    def _name(self):
        return "RGB_Diff_Distance"
