"""Semantic masks -> per-image CLS GeoTIFFs + root.json update.

ref: data_prep/processing/step_semantic.py:12-163 — npy pixel masks (from
prepare_annotations) become single-channel CLS GeoTIFFs with RPC tags copied
from the imagery; own / own_corrupted / own_no_cars variants; the class label
map is written into root.json (a copy of
``satnerf_tpu/data_prep/steps/step_semantic.py``).
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.data_prep.prepare_annotations import (
    LABELS,
    corrupt_labels,
    make_no_cars,
)
from satnerf_torch.data_prep.step_base import ProcessingStepBase
from satnerf_torch.io.json_io import read_json, write_json
from satnerf_torch.io.tiff import GeoProfile, read_geotiff, write_geotiff
from satnerf_torch.logger import logger


class ProcessingStep(ProcessingStepBase):
    def __init__(self, cfg, step_cfg, state):
        super().__init__(cfg, step_cfg, state)
        out = cfg.general.output_dp
        self.own_dp = os.path.join(out, "semantic_own")
        self.corr_dp = os.path.join(out, "semantic_own_corrupted")
        self.nocars_dp = os.path.join(out, "semantic_own_no_cars")

    def can_be_skipped(self, cfg, state):
        return os.path.isdir(self.own_dp) and len(os.listdir(self.own_dp)) > 0

    def run(self, cfg, state):
        masks_dp = cfg.general.semantic_masks_dp
        assert masks_dp and os.path.isdir(masks_dp), (
            "semantic_masks_dp must point to the npy masks from "
            "prepare_annotations"
        )
        for dp in (self.own_dp, self.corr_dp, self.nocars_dp):
            os.makedirs(dp, exist_ok=True)

        for img_i, name in enumerate(state["image_names"]):
            mask_fp = os.path.join(masks_dp, name + ".npy")
            if not os.path.isfile(mask_fp):
                # annotations may be named by location prefix without _RGB
                alt_fp = os.path.join(masks_dp, name.replace("_RGB", "") + ".npy")
                mask_fp = alt_fp if os.path.isfile(alt_fp) else mask_fp
            assert os.path.isfile(mask_fp), f"no mask for {name}"
            mask = np.load(mask_fp).astype(np.uint8)

            # copy RPC tags from the source image
            img_fp = os.path.join(state["image_dp"], name + ".tif")
            _, img_profile = read_geotiff(img_fp)
            assert mask.shape == (img_profile.height, img_profile.width), (
                f"{name}: mask {mask.shape} does not match image "
                f"({img_profile.height}, {img_profile.width}) — the RPC "
                "copied onto the CLS tif would map a different raster grid "
                "(masks annotated on uncropped/other-resolution imagery?)"
            )
            profile = GeoProfile(
                width=mask.shape[1], height=mask.shape[0], count=1,
                dtype="uint8", rpc=img_profile.rpc,
            )
            cls_name = name.replace("_RGB", "_CLS") + ".tif"
            write_geotiff(os.path.join(self.own_dp, cls_name), mask[None], profile)
            write_geotiff(
                os.path.join(self.corr_dp, cls_name),
                # per-image seed: the same seed for every view would
                # corrupt all views with a pixel-identical noise field —
                # perfectly view-correlated label noise that multi-view
                # training averages away, defeating the robustness variant
                corrupt_labels(mask, seed=cfg.general.seed + img_i)[None],
                profile,
            )
            write_geotiff(
                os.path.join(self.nocars_dp, cls_name),
                make_no_cars(mask)[None], profile,
            )

        self._update_root(cfg, state)
        logger.info(
            "DataPrep", f"semantic CLS tifs for {len(state['image_names'])} images"
        )

    def _update_root(self, cfg, state):
        root_fp = state.get(
            "root_fp", os.path.join(cfg.general.output_dp, "root.json")
        )
        if not os.path.isfile(root_fp):
            return
        root = read_json(root_fp)
        out = cfg.general.output_dp
        root["semantic_dp_own"] = os.path.relpath(self.own_dp, out)
        root["semantic_dp_own_corrupted"] = os.path.relpath(self.corr_dp, out)
        root["semantic_dp_own_no_cars"] = os.path.relpath(self.nocars_dp, out)
        root["semantic_cls_labels"] = {str(v): k for k, v in LABELS.items()}
        write_json(root_fp, root)

    def update_state(self, cfg, state, has_run):
        if os.path.isdir(self.own_dp):
            state["semantic_dp_own"] = self.own_dp
