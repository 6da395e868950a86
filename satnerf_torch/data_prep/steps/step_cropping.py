"""Crop each image to the GT-DSM ROI polygon, shifting RPC offsets.

ref: data_prep/processing/step_cropping.py:10-91 (a copy of
``satnerf_tpu/data_prep/steps/step_cropping.py``).
"""

from __future__ import annotations

import glob
import os

from satnerf_torch.data_prep import geo_utils
from satnerf_torch.data_prep.step_base import ProcessingStepBase
from satnerf_torch.io.json_io import read_json, write_json
from satnerf_torch.io.tiff import read_geotiff, read_geotiff_profile
from satnerf_torch.logger import logger


class ProcessingStep(ProcessingStepBase):
    def __init__(self, cfg, step_cfg, state):
        super().__init__(cfg, step_cfg, state)
        self.out_dp = os.path.join(cfg.general.output_dp, "images_cropped")

    def can_be_skipped(self, cfg, state):
        """Skip only when the previous run COMPLETED: every source image
        has a cropped tif whose dimensions match its (RPC-shifted) meta.
        A bare non-empty-dir check would skip over a partially-crashed run
        and feed downstream steps a mix of cropped and uncropped
        images/metas (rays offset by the crop origin, no error raised)."""
        if not os.path.isdir(self.out_dp):
            return False
        src = sorted(glob.glob(os.path.join(state["image_dp"], "*.tif")))
        if not src:
            return False
        for tif_fp in src:
            name = os.path.basename(tif_fp)
            out_fp = os.path.join(self.out_dp, name)
            meta_fp = os.path.join(state["metas_dp"], name[:-4] + ".json")
            if not (os.path.isfile(out_fp) and os.path.isfile(meta_fp)):
                return False
            prof = read_geotiff_profile(out_fp)
            meta = read_json(meta_fp)
            # a crash between write_geotiff and write_json leaves the
            # uncropped width/height (or RPC) in the meta
            if meta.get("width") != prof.width or meta.get("height") != prof.height:
                return False
        return True

    def run(self, cfg, state):
        os.makedirs(self.out_dp, exist_ok=True)
        poly = geo_utils.aoi_txt_to_lonlat_polygon(
            state["gt_txt_fp"], cfg.general.zone_string
        )
        for tif_fp in sorted(glob.glob(os.path.join(state["image_dp"], "*.tif"))):
            name = os.path.basename(tif_fp)
            out_fp = os.path.join(self.out_dp, name)
            meta_fp = os.path.join(state["metas_dp"], name[:-4] + ".json")
            meta = read_json(meta_fp)
            alt = 0.5 * (meta["min_alt"] + meta["max_alt"])
            c0, r0, w, h = geo_utils.crop_geotiff_to_lonlat_aoi(
                tif_fp, out_fp, poly, alt=alt
            )
            # update meta with the shifted RPC + new dimensions
            _, profile = read_geotiff(out_fp)
            meta["width"], meta["height"] = w, h
            meta["rpc"] = profile.rpc.to_dict()
            write_json(meta_fp, meta)
            logger.info(
                "DataPrep", f"cropped {name} -> ({w}x{h}) at col={c0} row={r0}"
            )

    def update_state(self, cfg, state, has_run):
        if has_run and os.path.isdir(self.out_dp):
            state["image_dp"] = self.out_dp
