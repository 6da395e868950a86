"""Geo helpers for dataset construction (ref: data_prep/utils/geo_utils.py;
a copy of ``satnerf_tpu/data_prep/geo_utils.py``).

AOI txt <-> polygons, DSM-txt affine transforms, and RPC-aware GeoTIFF
cropping (the rpcm.utils.crop_aoi replacement used by step_cropping).
"""

from __future__ import annotations

import numpy as np

from satnerf_torch.geo.rpc import RPCModel
from satnerf_torch.geo.utm import latlon_from_utm
from satnerf_torch.io.tiff import GeoProfile, read_geotiff, write_geotiff


def read_aoi_txt(fp: str):
    """DFC2019 _DSM.txt: easting, northing (south edge), size, resolution."""
    m = np.loadtxt(fp)
    return float(m[0]), float(m[1]), int(m[2]), float(m[3])


def aoi_txt_to_transform(fp: str):
    """north-up affine for the DSM raster described by the txt
    (ref: geo_utils.create_affine_transform_from_aoi_txt)."""
    xoff, yoff, size, res = read_aoi_txt(fp)
    return (res, res, xoff, yoff + size * res)


def aoi_txt_to_lonlat_polygon(fp: str, zone_string: str):
    """ROI corners as (lon, lat) closed polygon."""
    xoff, yoff, size, res = read_aoi_txt(fp)
    eastings = np.array([xoff, xoff + size * res, xoff + size * res, xoff])
    norths = np.array([yoff, yoff, yoff + size * res, yoff + size * res])
    lat, lon = latlon_from_utm(eastings, norths, zone_string)
    return np.stack([lon, lat], axis=1)


def crop_geotiff_to_lonlat_aoi(
    img_fp: str, out_fp: str, lonlat_poly: np.ndarray, alt: float = 0.0
):
    """Crop a GeoTIFF with an RPC tag to the pixel bbox of a lon/lat polygon,
    shifting the RPC row/col offsets so the cropped RPC stays valid.

    ref behavior: rpcm.utils.crop_aoi via step_cropping.py:30-43.
    Returns (col0, row0, width, height) of the applied crop.
    """
    arr, profile = read_geotiff(img_fp)
    assert profile.rpc is not None, f"{img_fp} has no RPC tag"
    rpc = profile.rpc

    cols, rows = rpc.projection(
        lonlat_poly[:, 0], lonlat_poly[:, 1], np.full(len(lonlat_poly), alt)
    )
    c0 = int(np.floor(cols.min()))
    r0 = int(np.floor(rows.min()))
    c1 = int(np.ceil(cols.max()))
    r1 = int(np.ceil(rows.max()))
    c0, r0 = max(c0, 0), max(r0, 0)
    c1 = min(c1, profile.width)
    r1 = min(r1, profile.height)
    assert c1 > c0 and r1 > r0, f"AOI does not intersect {img_fp}"

    cropped = arr[:, r0:r1, c0:c1]
    new_rpc = RPCModel.from_dict(rpc.to_dict())
    new_rpc.col_offset -= c0
    new_rpc.row_offset -= r0

    out_profile = GeoProfile(
        width=c1 - c0, height=r1 - r0, count=profile.count, dtype=profile.dtype,
        rpc=new_rpc, nodata=profile.nodata,
    )
    write_geotiff(out_fp, cropped, out_profile)
    return c0, r0, c1 - c0, r1 - r0
