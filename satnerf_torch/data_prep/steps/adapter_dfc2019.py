"""DFC2019 Track-3 adapter: copy imagery + ground truth, georegister the GT
DSM/watermask from the _DSM.txt, parse IMD sun angles, derive altitude
bounds, and extract per-image meta JSONs.

ref: data_prep/processing/adapter_DFC2019.py:24-347 (a copy of
``satnerf_tpu/data_prep/steps/adapter_dfc2019.py``).
"""

from __future__ import annotations

import datetime
import glob
import os
import shutil

import numpy as np

from satnerf_torch.data_prep import geo_utils
from satnerf_torch.data_prep.step_base import ProcessingStepBase
from satnerf_torch.io.json_io import write_json
from satnerf_torch.io.tiff import epsg_for_utm, read_geotiff, write_geotiff
from satnerf_torch.logger import logger

# predefined SatNeRF test splits (ref: adapter_DFC2019.py:341-347)
SATNERF_TEST_FILES = {
    "JAX_004": ["JAX_004_014_RGB", "JAX_004_009_RGB"],
    "JAX_068": ["JAX_068_002_RGB", "JAX_068_012_RGB"],
    "JAX_214": ["JAX_214_006_RGB", "JAX_214_001_RGB", "JAX_214_008_RGB"],
    "JAX_260": ["JAX_260_006_RGB", "JAX_260_004_RGB"],
}


def read_imd(imd_fp: str):
    """Parse meanSunAz / meanSunEl / TLCTime from a WorldView IMD file
    (ref: adapter_DFC2019.py:273-292). Tolerant of quoted/unquoted values
    and 2- or 4-digit years (real DFC2019 IMDs use unquoted
    '2014-10-09T15:44:31.632383Z')."""
    az = el = None
    time = None
    with open(imd_fp) as fp:
        for line in fp:
            if "=" not in line or ";" not in line:
                continue
            key_part, value = line.split("=", 1)
            key = key_part.strip()
            value = value.split(";")[0].strip().strip('"')
            if key == "meanSunAz":
                az = float(value)
            elif key == "meanSunEl":
                el = float(value)
            elif key == "TLCTime":
                for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%y-%m-%dT%H:%M:%S.%fZ",
                            "%Y-%m-%dT%H:%M:%SZ"):
                    try:
                        time = datetime.datetime.strptime(value, fmt)
                        break
                    except ValueError:
                        continue
    return az, el, time


class ProcessingStep(ProcessingStepBase):
    def __init__(self, cfg, step_cfg, state):
        super().__init__(cfg, step_cfg, state)
        g = cfg.general
        self.aoi = g.aoi_name
        self.loc3 = self.aoi.split("_")[0]
        self.out_dp = g.output_dp
        self.image_odp = os.path.join(self.out_dp, "images")
        self.metas_odp = os.path.join(self.out_dp, "metas")
        self.gt_ofp = os.path.join(self.out_dp, f"{self.aoi}_DSM.tif")
        self.gt_cls_ofp = os.path.join(self.out_dp, f"{self.aoi}_CLS.tif")
        self.gt_txt_ofp = os.path.join(self.out_dp, f"{self.aoi}_DSM.txt")

    def can_be_skipped(self, cfg, state):
        return (
            os.path.isdir(self.metas_odp)
            and len(glob.glob(os.path.join(self.metas_odp, "*.json"))) > 0
            and os.path.isfile(self.gt_ofp)
        )

    def run(self, cfg, state):
        g = cfg.general
        os.makedirs(self.image_odp, exist_ok=True)
        os.makedirs(self.metas_odp, exist_ok=True)

        # ground truth + georegistration fix (the distribution DSM tif has no
        # transform; apply the _DSM.txt, ref: adapter:118-156)
        truth = g.dfc_truth_dp
        shutil.copy(os.path.join(truth, f"{self.aoi}_DSM.txt"), self.gt_txt_ofp)
        transform = geo_utils.aoi_txt_to_transform(self.gt_txt_ofp)
        epsg = epsg_for_utm(g.zone_string)
        for src_name, out_fp in (
            (f"{self.aoi}_DSM.tif", self.gt_ofp),
            (f"{self.aoi}_CLS.tif", self.gt_cls_ofp),
        ):
            arr, profile = read_geotiff(os.path.join(truth, src_name))
            profile.transform = transform
            profile.epsg = epsg
            write_geotiff(out_fp, arr, profile)

        # optional ignore mask (ref: adapter:158-183 copy_ignore_mask): when
        # present it replaces the water mask in MAE computation
        if g.ignore_masks_dp:
            src = os.path.join(g.ignore_masks_dp, f"{self.aoi}_ignore.tif")
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(self.out_dp, f"{self.aoi}_ignore.tif"))
                logger.info("DataPrep", "ignore mask copied")

        # copy imagery
        for tif_fp in sorted(
            glob.glob(os.path.join(g.dfc_rgb_dp, f"{self.aoi}_*_RGB.tif"))
        ):
            shutil.copy(tif_fp, os.path.join(self.image_odp, os.path.basename(tif_fp)))

        self.extract_metas(cfg)

    def extract_metas(self, cfg):
        g = cfg.general
        dsm, _ = read_geotiff(self.gt_ofp)
        if g.alt_min is not None and g.alt_max is not None:
            min_alt, max_alt = g.alt_min, g.alt_max
        else:
            # scene altitude bounds from the GT DSM +- 1 m (ref: adapter:255-260)
            valid = dsm[0][np.isfinite(dsm[0])]
            min_alt = int(np.round(valid.min() - 1))
            max_alt = int(np.round(valid.max() + 1))
        logger.info("DataPrep", f"altitude bounds: [{min_alt}, {max_alt}]")

        for tif_fp in sorted(glob.glob(os.path.join(self.image_odp, "*.tif"))):
            basename = os.path.basename(tif_fp)
            arr, profile = read_geotiff(tif_fp)
            meta = {
                "img": basename,
                "width": profile.width,
                "height": profile.height,
                "min_alt": float(min_alt),
                "max_alt": float(max_alt),
            }
            if profile.rpc is not None:
                meta["rpc"] = profile.rpc.to_dict()

            # IMD: "JAX_004_009_RGB" -> "09.IMD" (ref: adapter:238)
            imd_name = basename[: basename.find("_RGB")][-2:] + ".IMD"
            imd_fp = os.path.join(g.dfc_metadata_dp, self.loc3, imd_name)
            if os.path.isfile(imd_fp):
                az, el, time = read_imd(imd_fp)
                meta["sun_azimuth"] = az
                meta["sun_elevation"] = el
                if time is not None:
                    meta["acquisition_date"] = time.strftime("%Y%m%d%H%M%S")
            else:
                logger.warning("DataPrep", f"no IMD for {basename}; sun at zenith")
                meta["sun_azimuth"] = 180.0
                meta["sun_elevation"] = 90.0

            write_json(
                os.path.join(self.metas_odp, basename[:-4] + ".json"), meta
            )

    def update_state(self, cfg, state, has_run):
        names = sorted(
            os.path.basename(fp)[:-4]
            for fp in glob.glob(os.path.join(self.image_odp, "*.tif"))
        )
        state.update(
            {
                "image_dp": self.image_odp,
                "metas_dp": self.metas_odp,
                "gt_dsm_fp": self.gt_ofp,
                "gt_cls_fp": self.gt_cls_ofp,
                "gt_txt_fp": self.gt_txt_ofp,
                "image_names": names,
                "test_files": SATNERF_TEST_FILES.get(self.aoi, []),
            }
        )
        ignore_fp = os.path.join(self.out_dp, f"{self.aoi}_ignore.tif")
        if os.path.isfile(ignore_fp):
            state["ignore_mask_fp"] = ignore_fp
