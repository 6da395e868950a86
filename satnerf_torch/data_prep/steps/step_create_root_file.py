"""Create the root.json dataset manifest with train/test splits.

ref: data_prep/processing/step_create_root_file.py:18-163 — paths to
images/metas/DSM/watermask, zone string, tie points, the train/test split
(predefined SatNeRF files | random | fixed-count | custom list) and the DSM
centre coordinates (a copy of
``satnerf_tpu/data_prep/steps/step_create_root_file.py``).
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.data_prep.step_base import ProcessingStepBase
from satnerf_torch.geo.utm import latlon_from_utm
from satnerf_torch.io.json_io import write_json
from satnerf_torch.io.tiff import read_geotiff
from satnerf_torch.logger import logger


class ProcessingStep(ProcessingStepBase):
    def __init__(self, cfg, step_cfg, state):
        super().__init__(cfg, step_cfg, state)
        self.root_fp = os.path.join(cfg.general.output_dp, "root.json")

    def can_be_skipped(self, cfg, state):
        return os.path.isfile(self.root_fp)

    def _split(self, cfg, state):
        names = list(state["image_names"])
        mode = cfg.general.split_mode
        if mode == "predefined":
            test = [n for n in names if n in set(state.get("test_files", []))]
            if not test:
                logger.warning(
                    "DataPrep", "no predefined test files found; fixed split"
                )
                test = names[-cfg.general.n_test :]
        elif mode == "custom":
            test = [n for n in names if n in set(cfg.general.custom_test_files)]
        elif mode == "random":
            rng = np.random.default_rng(cfg.general.seed)
            test = list(rng.choice(names, cfg.general.n_test, replace=False))
        else:  # fixed
            test = names[-cfg.general.n_test :]
        train = [n for n in names if n not in set(test)]
        return train, test

    def run(self, cfg, state):
        g = cfg.general
        out = g.output_dp
        train, test = self._split(cfg, state)

        dsm, profile = read_geotiff(state["gt_dsm_fp"])
        ce, cn = profile.pixel_to_xy(profile.width / 2, profile.height / 2)
        clat, clon = latlon_from_utm(
            np.array([ce]), np.array([cn]), g.zone_string
        )

        root = {
            "aoi_name": g.aoi_name,
            "img_dp": os.path.relpath(state["image_dp"], out),
            "meta_dp": os.path.relpath(state["metas_dp"], out),
            "dsm_txt_fp": os.path.relpath(state["gt_txt_fp"], out),
            "dsm_tif_fp": os.path.relpath(state["gt_dsm_fp"], out),
            "dsm_cls_fp": os.path.relpath(state["gt_cls_fp"], out),
            "zone_string": g.zone_string,
            "train_split": [n + ".json" for n in train],
            "test_split": [n + ".json" for n in test],
            "dsm_center_lons": float(clon[0]),
            "dsm_center_lats": float(clat[0]),
            "dsm_center_alts": float(np.nanmean(dsm[0][np.isfinite(dsm[0])])),
        }
        if state.get("points3d_fp"):
            root["points3d_fp"] = os.path.relpath(state["points3d_fp"], out)
        if state.get("ignore_mask_fp"):
            root["ignore_mask_fp"] = os.path.relpath(state["ignore_mask_fp"], out)
        write_json(self.root_fp, root)
        logger.info(
            "DataPrep",
            f"root.json: {len(train)} train / {len(test)} test images",
        )

    def update_state(self, cfg, state, has_run):
        state["root_fp"] = self.root_fp
