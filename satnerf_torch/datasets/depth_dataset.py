"""Depth-supervision dataset from bundle-adjustment tie points.

ref: baseline/dataset/satnerf_depth_dataset.py:24-192 — sparse rays through
the 2D keypoints of each image, target depth = distance from the (normalised)
ray origin to the tie point, weighted by exp(-(e/e_mean)^2) over summed
reprojection errors across all cameras.
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.core.rays import build_rays_from_rpc, construct_sun_dir
from satnerf_torch.datasets.base import BaseDataset
from satnerf_torch.datasets.satnerf_dataset import construct_rpc_camera_model
from satnerf_torch.geo.coordinate_systems import CoordinateSystemECEF
from satnerf_torch.io.json_io import get_file_id, read_json


class DepthDataset(BaseDataset):
    def __init__(self, cfg, dataset_name: str, split: str = "train") -> None:
        super().__init__(cfg, dataset_name, split)
        assert split == "train", "depth dataset is train-only"
        assert "points3d_fp" in self.root, (
            "depth supervision requires a bundle-adjusted dataset (points3d_fp)"
        )
        self.points3d_fp = os.path.join(
            cfg.run.dataset_dp, self.root["points3d_fp"]
        )
        self.tie_points: np.ndarray | None = None
        self.kp_weights: np.ndarray | None = None

    def _init_dataset_creation(self) -> None:
        self.tie_points = np.load(self.points3d_fp)
        self.kp_weights = self._load_keypoint_weights()

    def _load_keypoint_weights(self) -> np.ndarray:
        """Reprojection-error weights across all cameras
        (ref: satnerf_depth_dataset.py:137-167)."""
        n_pts = self.tie_points.shape[0]
        n_cams = len(self.data_names)
        errors = np.zeros((n_pts, n_cams), dtype=np.float32)
        ecef = CoordinateSystemECEF()  # tie points are stored in ECEF
        for t, name in enumerate(self.data_names):
            meta = read_json(os.path.join(self.meta_dp, name))
            assert "keypoints" in meta, f"no keypoints in {name}"
            pts2d = np.asarray(meta["keypoints"]["2d_coordinates"], np.float64)
            idx = np.asarray(meta["keypoints"]["pts3d_indices"], np.int64)
            pts3d = self.tie_points[idx]
            cam = construct_rpc_camera_model(meta)
            lat, lon, alt = ecef.to_lat_lon(pts3d[:, 0], pts3d[:, 1], pts3d[:, 2])
            col, row = cam.projection(lon, lat, alt)
            reproj = np.stack([col, row], axis=1)
            errors[idx, t] = np.linalg.norm(pts2d - reproj, axis=1)
        e = errors.sum(axis=1)
        e_mean = max(float(e.mean()), 1e-12)
        return np.exp(-((e / e_mean) ** 2)).astype(np.float32)

    def _create_item(
        self, name: str, index: int, meta: dict, load_from_cache: bool
    ) -> dict:
        assert self.normalization is not None, (
            "depth dataset must be loaded after RGB normalization is initialised"
        )
        img_id = get_file_id(meta["img"])
        pts2d = np.asarray(meta["keypoints"]["2d_coordinates"], np.float64)
        idx = np.asarray(meta["keypoints"]["pts3d_indices"], np.int64)
        pts3d = self.tie_points[idx].astype(np.float64)

        if not isinstance(self.coordinate_system, CoordinateSystemECEF):
            # stored ECEF -> training frame (ref: satnerf_depth_dataset.py:60-70)
            ecef = CoordinateSystemECEF()
            lat, lon, alt = ecef.to_lat_lon(pts3d[:, 0], pts3d[:, 1], pts3d[:, 2])
            x, y, z = self.coordinate_system.from_latlon(lat, lon, alt)
            pts3d = np.stack([x, y, z], axis=1)

        cols, rows = pts2d[:, 0], pts2d[:, 1]
        rays = build_rays_from_rpc(
            construct_rpc_camera_model(meta),
            self.coordinate_system,
            rows=rows,
            cols=cols,
            min_alt=float(meta["min_alt"]),
            max_alt=float(meta["max_alt"]),
        )
        # normalise immediately (ref: satnerf_depth_dataset.py:88-92)
        rays = self.normalization.normalize_rays(rays)
        pts3d_n = self.normalization.normalize_xyz(pts3d)

        depths = np.linalg.norm(
            pts3d_n - rays[:, :3].astype(np.float64), axis=1
        ).astype(np.float32)
        weights = self.kp_weights[idx].astype(np.float32)

        n_rays = rays.shape[0]
        sun_dirs = construct_sun_dir(
            float(meta["sun_elevation"]), float(meta["sun_azimuth"]), n_rays
        )
        extras = np.concatenate(
            [sun_dirs, np.full((n_rays, 1), index, np.float32)], axis=1
        )
        return {
            "rays": rays,
            "depths": depths[:, None],
            "weights": weights[:, None],
            "extras": extras,
            "name": img_id,
            "w": int(meta["width"]),
            "h": int(meta["height"]),
        }

    def normalize(self) -> None:
        # already normalised during item creation (ref: depth_dataset:185-189)
        self._combine()
