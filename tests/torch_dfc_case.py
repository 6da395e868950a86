"""A DFC2019 Track-3 distribution written from the port's generated scene,
for the data_prep tests and for ``chip_smoke.py``'s ``prep_scene`` phase
(imports no JAX).

The layout is the one ``satnerf_torch.data_prep.steps.adapter_dfc2019``
reads, built as the JAX package's fixture builds it
(``tests/test_data_prep.py:raw_dfc``):

* ``Track3-RGB/<AOI>_<nnn>_RGB.tif``: the views with their RPC tags;
* ``Track3-Truth/<AOI>_DSM.tif`` and ``<AOI>_CLS.tif`` with the
  georeferencing removed (the distribution's quirk the adapter repairs from
  ``<AOI>_DSM.txt``), and that ``_DSM.txt``;
* ``Track3-Metadata/<loc>/<nn>.IMD``: sun angles and an acquisition time
  in the WorldView IMD syntax;
* ``masks_full/<name>.npy``: each view's semantic mask on its uncropped
  grid, as ``prepare_annotations`` would write it.

Masks for a pipeline with ``step_cropping`` are cut on each view's cropped
grid by ``crop_masks``, after a run of the pipeline up to the cropping step:
the window is the shift between the raw image's RPC and the cropped meta's.
"""

from __future__ import annotations

import glob
import os
import shutil

import numpy as np

from satnerf_torch.configs import _toml_value
from satnerf_torch.datasets.synthetic import generate_scene
from satnerf_torch.io.json_io import read_json
from satnerf_torch.io.tiff import read_geotiff, write_geotiff

AOI = "JAX_068"


def write_distribution(base: str, n_views: int, img_size: int, aoi: str = AOI,
                       n_tie_points: int = 300, seed: int = 0) -> dict:
    """Writes the distribution under ``base``; returns its directories
    (``syn`` is the generated scene it was made from)."""
    syn = os.path.join(base, "syn")
    generate_scene(syn, n_train=n_views, n_test=0, img_size=img_size,
                   n_tie_points=n_tie_points, aoi_name=aoi, seed=seed)
    dist = {"base": base, "syn": syn, "aoi": aoi,
            "rgb_dp": os.path.join(base, "Track3-RGB"),
            "truth_dp": os.path.join(base, "Track3-Truth"),
            "metadata_dp": os.path.join(base, "Track3-Metadata"),
            "masks_full": os.path.join(base, "masks_full")}
    imd_dp = os.path.join(dist["metadata_dp"], aoi.split("_")[0])
    for dp in (dist["rgb_dp"], dist["truth_dp"], imd_dp, dist["masks_full"]):
        os.makedirs(dp, exist_ok=True)

    for fp in sorted(glob.glob(os.path.join(syn, "images", "*.tif"))):
        shutil.copy(fp, dist["rgb_dp"])
    for kind in ("DSM", "CLS"):
        arr, profile = read_geotiff(os.path.join(syn, f"{aoi}_{kind}.tif"))
        profile.transform = None
        profile.epsg = None
        write_geotiff(os.path.join(dist["truth_dp"], f"{aoi}_{kind}.tif"), arr, profile)
    shutil.copy(os.path.join(syn, f"{aoi}_DSM.txt"), dist["truth_dp"])

    for v, meta_fp in enumerate(sorted(glob.glob(os.path.join(syn, "metas", "*.json")))):
        meta = read_json(meta_fp)
        name = os.path.basename(meta_fp)[:-5]
        with open(os.path.join(imd_dp, name[: name.find("_RGB")][-2:] + ".IMD"), "w") as f:
            f.write(f"\tmeanSunAz = {meta['sun_azimuth']:.2f};\n"
                    f"\tmeanSunEl = {meta['sun_elevation']:.2f};\n"
                    f"\tTLCTime = 2014-10-{v % 28 + 1:02d}T15:44:31.632383Z;\n")
        cls, _ = read_geotiff(os.path.join(syn, "semantic_own", name.replace("_RGB", "_CLS")
                                           + ".tif"))
        np.save(os.path.join(dist["masks_full"], name + ".npy"), cls[0].astype(np.uint8))
    return dist


def general(dist: dict, output_dp: str, masks_dp: str | None = None, **kw) -> dict:
    """The ``[general]`` section of a dataset config over ``dist``."""
    g = {"aoi_name": dist["aoi"], "lazy": True, "dfc_rgb_dp": dist["rgb_dp"],
         "dfc_truth_dp": dist["truth_dp"], "dfc_metadata_dp": dist["metadata_dp"],
         "output_dp": output_dp, "zone_string": "17R"}
    if masks_dp is not None:
        g["semantic_masks_dp"] = masks_dp
    return {**g, **kw}


def _toml(v) -> str:
    """``configs.write_toml``'s values, and a dict as an inline table."""
    if isinstance(v, dict):
        return "{ " + ", ".join(f"{k} = {_toml(x)}" for k, x in v.items()) + " }"
    return _toml_value(v)


def write_config(fp: str, general_d: dict, steps: list) -> str:
    """A dataset-config TOML: ``[general]`` and one ``[[steps]]`` table per
    step dict (``params`` as an inline table)."""
    lines = ["[general]"] + [f"{k} = {_toml(v)}" for k, v in general_d.items()]
    for step in steps:
        lines += ["", "[[steps]]"] + [f"{k} = {_toml(v)}" for k, v in step.items()]
    with open(fp, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fp


def crop_masks(dist: dict, output_dp: str, masks_dp: str) -> dict:
    """Each view's full-grid mask cut at its crop window (the raw RPC's
    offsets minus the cropped meta's) into ``masks_dp``; -> {name: (col0,
    row0, width, height)}."""
    os.makedirs(masks_dp, exist_ok=True)
    windows = {}
    for meta_fp in sorted(glob.glob(os.path.join(output_dp, "metas", "*.json"))):
        meta = read_json(meta_fp)
        name = os.path.basename(meta_fp)[:-5]
        _, raw = read_geotiff(os.path.join(dist["rgb_dp"], name + ".tif"))
        c0 = int(round(raw.rpc.col_offset - meta["rpc"]["col_offset"]))
        r0 = int(round(raw.rpc.row_offset - meta["rpc"]["row_offset"]))
        w, h = meta["width"], meta["height"]
        mask = np.load(os.path.join(dist["masks_full"], name + ".npy"))[r0:r0 + h, c0:c0 + w]
        assert mask.shape == (h, w), (name, mask.shape, (h, w))
        np.save(os.path.join(masks_dp, name + ".npy"), mask)
        windows[name] = (c0, r0, w, h)
    return windows


PREP_STEPS = [
    {"file": "adapter_dfc2019"},
    {"file": "step_cropping"},
    {"file": "step_bundle_adjustment", "params": {"mode": "native"}},
    {"file": "step_finish_meta_extraction"},
    {"file": "step_create_root_file"},
    {"file": "step_semantic"},
]
