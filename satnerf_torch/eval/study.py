"""DSM study tools (port of ``satnerf_tpu/eval/study.py``): a colormapped
PNG of a GeoTIFF band, and a point cloud of a GT DSM raster.

CLI:
    python -m satnerf_torch.eval.study tif2png <tif> [out_png] [--cmap jet]
    python -m satnerf_torch.eval.study dsm2ply <dsm_tif> [out_ply]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from satnerf_torch.eval.extract_pointcloud import save_ply
from satnerf_torch.io.png import save_png
from satnerf_torch.io.tiff import read_geotiff
from satnerf_torch.viz.colormaps import apply_colormap


def extract_image_from_tif(tif_fp: str, out_fp: str | None = None, cmap: str = "jet") -> str:
    arr, _ = read_geotiff(tif_fp)
    img = (apply_colormap(arr[0], cmap) * 255).astype(np.uint8)
    out_fp = out_fp or os.path.splitext(tif_fp)[0] + ".png"
    save_png(img, out_fp)
    return out_fp


def extract_pc_from_dsm(dsm_fp: str, out_fp: str | None = None) -> str:
    arr, profile = read_geotiff(dsm_fp)
    dsm = arr[0]
    rows, cols = np.nonzero(np.isfinite(dsm))
    x, y = profile.pixel_to_xy(cols + 0.5, rows + 0.5)
    z = dsm[rows, cols]
    pts = np.stack([x, y, z], axis=1)
    zn = (z - z.min()) / max(z.max() - z.min(), 1e-9)
    colors = apply_colormap(zn.reshape(-1, 1), "jet").reshape(-1, 3)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (pts.shape[0], 1))
    out_fp = out_fp or os.path.splitext(dsm_fp)[0] + ".ply"
    save_ply(pts, colors, normals, out_fp)
    return out_fp


def main(argv=None):
    from satnerf_torch.eval.eval_nerf import _parse

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd, *rest = argv
    args, kwargs = _parse(rest)
    out = {"tif2png": extract_image_from_tif, "dsm2ply": extract_pc_from_dsm}[cmd](
        *args, **kwargs)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
