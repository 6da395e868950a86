"""DSM construction and NCC-registered altitude MAE.

ref: eval/utils/dsm.py:18-265 — back-project rays+depths to lat/lon/alt,
build a UTM point-cloud DSM at 0.5 m (or the ROI metadata resolution), crop
predicted + GT DSMs to the lidar ROI, mask water (CLS==9) or an ignore mask,
register the prediction to the GT via multiscale NCC, and report
mean/median absolute altitude error. The gdal.Translate projWin crops are
replaced by windowed reads through the in-house GeoTIFF layer.
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.geo.utm import utm_from_latlon
from satnerf_torch.io.tiff import GeoProfile, epsg_for_utm, read_geotiff, write_geotiff
from satnerf_torch.ops import dsm_register
from satnerf_torch.ops.rasterize import rasterize_mean


def get_utm_cloud(lats, lons, alts):
    """(ref: dsm.py:18-31)."""
    easts, norths, zone_string = utm_from_latlon(lats, lons)
    cloud = np.stack([easts, norths, np.asarray(alts)], axis=1)
    return cloud, zone_string


def create_dsm_cloud_from_nerf(dataset, rays, depths):
    lats, lons, alts = dataset.get_latlonalt_from_nerf_prediction(rays, depths)
    cloud, _ = get_utm_cloud(lats, lons, alts)
    return cloud


def create_dsm(lats, lons, alts, dsm_path=None, roi_txt=None):
    """Rasterize predicted points to a DSM GeoTIFF (ref: dsm.py:39-102)."""
    cloud, zone_string = get_utm_cloud(lats, lons, alts)

    if roi_txt is not None:
        meta = np.loadtxt(roi_txt)
        xoff, yoff = meta[0], meta[1]
        xsize = ysize = int(meta[2])
        resolution = meta[3]
        yoff += ysize * resolution  # roi yoff is the south edge (ref: dsm.py:63)
    else:
        resolution = 0.5
        xmin, xmax = cloud[:, 0].min(), cloud[:, 0].max()
        ymin, ymax = cloud[:, 1].min(), cloud[:, 1].max()
        xoff = np.floor(xmin / resolution) * resolution
        xsize = int(1 + np.floor((xmax - xoff) / resolution))
        yoff = np.ceil(ymax / resolution) * resolution
        ysize = int(1 - np.floor((ymin - yoff) / resolution))

    dsm = rasterize_mean(
        cloud, xoff, yoff, resolution, xsize, ysize, radius=1
    ).astype(np.float32)

    if dsm_path is not None:
        profile = GeoProfile(
            width=xsize, height=ysize, count=1, dtype="float32",
            transform=(resolution, resolution, float(xoff), float(yoff)),
            epsg=epsg_for_utm(zone_string),
            nodata=float("nan"),
        )
        write_geotiff(dsm_path, dsm[None], profile)
    return dsm


def _crop_to_window(arr, profile: GeoProfile, ulx, uly, lrx, lry):
    """gdal.Translate projWin equivalent: crop (pad with nan) to the window."""
    sx, sy, xoff, yoff = profile.transform
    c0 = int(round((ulx - xoff) / sx))
    r0 = int(round((yoff - uly) / sy))
    ncols = int(round((lrx - ulx) / sx))
    nrows = int(round((uly - lry) / sy))
    out = np.full((nrows, ncols), np.nan, dtype=np.float64)
    src = arr.astype(np.float64)
    r1, c1 = r0 + nrows, c0 + ncols
    sr0, sc0 = max(r0, 0), max(c0, 0)
    sr1, sc1 = min(r1, src.shape[0]), min(c1, src.shape[1])
    if sr1 > sr0 and sc1 > sc0:
        out[sr0 - r0 : sr1 - r0, sc0 - c0 : sc1 - c0] = src[sr0:sr1, sc0:sc1]
    new_profile = GeoProfile(
        width=ncols, height=nrows, count=1, dtype="float64",
        transform=(sx, sy, ulx, uly), epsg=profile.epsg, nodata=float("nan"),
    )
    return out, new_profile


def compute_dsm_and_mae(dataset, rays, depths, output_dp, img_name, epoch):
    """Validation-time DSM + MAE for one rendered image (ref: dsm.py:105-140)."""
    lats, lons, alts = dataset.get_latlonalt_from_nerf_prediction(rays, depths)
    return compute_dsm_and_mae_from_latlon(
        lats, lons, alts, dataset, output_dp, img_name, epoch
    )


def compute_dsm_and_mae_from_latlon(lats, lons, alts, dataset, output_dp, img_name, epoch):
    os.makedirs(output_dp, exist_ok=True)
    output_fp = os.path.join(output_dp, f"{img_name}_DSM_epoch_{epoch}.tif")
    metadata = np.loadtxt(dataset.dsm_txt_fp)
    create_dsm(lats, lons, alts, output_fp)

    watermask_fp, ignore_mask_fp = None, None
    if dataset.ignore_mask_fp:
        ignore_mask_fp = dataset.ignore_mask_fp
    else:
        watermask_fp = dataset.dsm_cls_fp

    return compute_mae(
        output_fp, dataset.dsm_tif_fp, metadata, output_dp,
        gt_water_mask_fp=watermask_fp, ignore_mask_fp=ignore_mask_fp,
    )


def compute_mae(
    dsm_nerf_fp,
    gt_fp,
    dsm_metadata,
    output_dp,
    gt_water_mask_fp=None,
    ignore_mask_fp=None,
):
    """Registered altitude MAE between predicted and GT DSM
    (ref: dsm.py:143-265)."""
    assert (gt_water_mask_fp is None) + (ignore_mask_fp is None) == 1, (
        "either watermask or ignore mask must be given for MAE"
    )

    xoff, yoff = dsm_metadata[0], dsm_metadata[1]
    xsize = ysize = int(dsm_metadata[2])
    resolution = dsm_metadata[3]
    ulx, uly = xoff, yoff + ysize * resolution
    lrx, lry = xoff + xsize * resolution, yoff

    pred_arr, pred_prof = read_geotiff(dsm_nerf_fp)
    pred, pred_prof = _crop_to_window(pred_arr[0], pred_prof, ulx, uly, lrx, lry)

    gt_arr, gt_prof = read_geotiff(gt_fp)
    gt, _ = _crop_to_window(gt_arr[0], gt_prof, ulx, uly, lrx, lry)
    gt[gt < -500.0] = 0.0  # clamp nodata depths (ref: dsm.py:232)

    if gt_water_mask_fp and os.path.isfile(gt_water_mask_fp):
        wm_arr, wm_prof = read_geotiff(gt_water_mask_fp)
        wm, _ = _crop_to_window(wm_arr[0], wm_prof, ulx, uly, lrx, lry)
        pred[wm == 9] = np.nan  # DFC2019: water class == 9
    if ignore_mask_fp and os.path.isfile(ignore_mask_fp):
        # The reference (eval/utils/dsm.py:218-220) reads the ignore mask
        # raw and assumes it is already ROI-sized — typically a plain
        # non-georeferenced tif, which _crop_to_window cannot handle
        # (transform=None). Only crop when the mask is georeferenced AND
        # its size differs from the ROI.
        im_arr, im_prof = read_geotiff(ignore_mask_fp)
        im = im_arr[0]
        if im.shape != pred.shape:
            if im_prof.transform is None:
                raise ValueError(
                    f"ignore mask {ignore_mask_fp} is {im.shape}, not the "
                    f"ROI size {pred.shape}, and carries no geotransform "
                    "to crop by"
                )
            im, _ = _crop_to_window(im, im_prof, ulx, uly, lrx, lry)
        # _crop_to_window pads with NaN and np.bool_(nan) is True: padding
        # must mean "keep the pixel", never "ignore it"
        im = np.nan_to_num(im, nan=0.0)
        pred[im.astype(bool)] = np.nan

    transform = dsm_register.compute_shift(gt, pred, scaling=False)
    pred_r = dsm_register.apply_shift(pred, *transform)

    diff = pred_r - gt
    err_fp = os.path.join(
        output_dp, os.path.basename(dsm_nerf_fp)[:-4] + "_error.tif"
    )
    write_geotiff(
        err_fp, diff.astype(np.float32)[None],
        GeoProfile(diff.shape[1], diff.shape[0], 1, "float32",
                   transform=pred_prof.transform, epsg=pred_prof.epsg,
                   nodata=float("nan")),
    )
    return {
        "mean": "{:.3f}".format(np.nanmean(np.abs(diff.ravel()))),
        "median": "{:.3f}".format(np.nanmedian(np.abs(diff.ravel()))),
    }
