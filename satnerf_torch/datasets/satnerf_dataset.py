"""RGB ray dataset: per-image GeoTIFF + RPC rays + sun dirs + timestamps.

ref: baseline/dataset/satnerf_dataset.py:31-206. Rays are built on host in
float64 (RPC Newton localization), cached as .npy per image, then packed
float32 for the device.
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.core.rays import build_rays_from_rpc, construct_sun_dir
from satnerf_torch.datasets.base import BaseDataset
from satnerf_torch.geo.rpc import RPCModel, rescale_rpc
from satnerf_torch.io.image import load_rgb_tensor
from satnerf_torch.io.json_io import get_file_id


def construct_rpc_camera_model(meta: dict, scale_factor: float = 1.0) -> RPCModel:
    """RPC camera from the meta-JSON dict (ref:
    baseline/components/camera_models.py:24-36)."""
    rpc = RPCModel.from_dict(meta["rpc"])
    if scale_factor != 1.0:
        rpc = rescale_rpc(rpc, 1.0 / scale_factor)
    return rpc


class SatNeRFDataset(BaseDataset):
    def __init__(self, cfg, dataset_name: str, split: str) -> None:
        super().__init__(cfg, dataset_name, split)
        self.cache_name = (
            "rays_utm" if cfg.pipeline.use_utm_coordinate_system else "rays"
        )

    # -- cache -------------------------------------------------------------
    def has_already_been_cached(self) -> bool:
        if not self.cache.exists(self.cache_name):
            return False
        dp = self.cache.dir_path(self.cache_name)
        return all(
            os.path.isfile(os.path.join(dp, get_file_id(n) + ".npy"))
            for n in self.data_names
        )

    def save_to_cache(self) -> None:
        """Persist UNNORMALISED rays (call before normalize(), matching the
        reference order base_ray_pipeline.py:225-227)."""
        if self.has_already_been_cached():
            return
        dp = self.cache.dir_path(self.cache_name)
        for item in self.data:
            np.save(os.path.join(dp, item["name"] + ".npy"), item["rays"])

    # -- item construction ---------------------------------------------------
    def _create_item(
        self, name: str, index: int, meta: dict, load_from_cache: bool
    ) -> dict:
        img_fp = os.path.join(self.img_dp, meta["img"])
        img_id = get_file_id(meta["img"])
        rgbs = load_rgb_tensor(img_fp)

        h, w = int(meta["height"]), int(meta["width"])
        min_alt, max_alt = float(meta["min_alt"]), float(meta["max_alt"])

        if load_from_cache:
            rays = np.load(
                os.path.join(self.cache.dir_path(self.cache_name), img_id + ".npy")
            )
        else:
            cols, rows = np.meshgrid(np.arange(w), np.arange(h))
            rays = build_rays_from_rpc(
                construct_rpc_camera_model(meta),
                self.coordinate_system,
                rows=rows,
                cols=cols,
                min_alt=min_alt,
                max_alt=max_alt,
            )

        assert rgbs.shape[0] == rays.shape[0], (
            f"rgb & ray counts differ in {name}: {rgbs.shape[0]} vs {rays.shape[0]}"
        )
        n_rays = rays.shape[0]
        sun_dirs = construct_sun_dir(
            float(meta["sun_elevation"]), float(meta["sun_azimuth"]), n_rays
        )
        ts = np.full((n_rays, 1), index, dtype=np.float32)
        extras = np.concatenate([sun_dirs, ts], axis=1)

        return {
            "rays": rays,
            "rgbs": rgbs.astype(np.float32),
            "extras": extras,
            "name": img_id,
            "w": w,
            "h": h,
            "alt_min": min_alt,
            "alt_max": max_alt,
        }

    # -- back-projection (ref: satnerf_dataset.py:157-206) -----------------
    def get_xyz_from_nerf_prediction(self, rays, depth) -> np.ndarray:
        rays = np.asarray(rays, dtype=np.float64)
        depth = np.asarray(depth, dtype=np.float64).reshape(-1, 1)
        return rays[:, 0:3] + rays[:, 3:6] * depth

    def get_latlonalt_from_nerf_prediction(self, rays, depth):
        xyz_n = self.get_xyz_from_nerf_prediction(rays, depth)
        return self.get_latlonalt_from_points(xyz_n)

    def get_latlonalt_from_points(self, points):
        assert self.normalization is not None
        xyz = self.normalization.denormalize_xyz(np.asarray(points, np.float64))
        return self.coordinate_system.to_lat_lon(xyz[:, 0], xyz[:, 1], xyz[:, 2])
