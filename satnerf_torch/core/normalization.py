"""Scene normalization: joint bounding of all ray endpoints.

ref: baseline/components/normalization.py:11-104 (StandardNormalization):
collect origins and far endpoints of ALL rays (train+test), per-axis
scale=(max-min)/2 and offset=min+scale, normalize xyz by the max scale, and
divide near/far by the same range. Parameters are cached as JSON so depth
datasets and eval back-projection share the exact frame.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from satnerf_torch.core.rays import ray_component, set_ray_component

_KEYS = ("X_scale", "X_offset", "Y_scale", "Y_offset", "Z_scale", "Z_offset")


@dataclass
class SceneNormalization:
    params: dict

    # -- construction ------------------------------------------------------
    @classmethod
    def from_rays(cls, rays: np.ndarray) -> "SceneNormalization":
        """Compute params from a combined (N, 8) ray tensor.

        ref: normalization.py:84-104 (_calculate_normalization_params).
        """
        origins = np.asarray(ray_component(rays, "origins"), dtype=np.float64)
        dirs = np.asarray(ray_component(rays, "directions"), dtype=np.float64)
        fars = np.asarray(ray_component(rays, "far"), dtype=np.float64)
        points = np.concatenate([origins, origins + fars * dirs], axis=0)

        params = {}
        for axis, name in enumerate("XYZ"):
            v = points[:, axis]
            scale = (v.max() - v.min()) / 2.0
            offset = v.min() + scale
            params[f"{name}_scale"] = float(scale)
            params[f"{name}_offset"] = float(offset)
        return cls(params)

    @classmethod
    def from_json(cls, fp: str) -> "SceneNormalization":
        with open(fp) as f:
            return cls(json.load(f))

    def save_json(self, fp: str) -> None:
        d = os.path.dirname(fp)
        if d:  # bare filename: makedirs('') raises
            os.makedirs(d, exist_ok=True)
        with open(fp, "w") as f:
            json.dump(self.params, f, indent=2)

    # -- core quantities ---------------------------------------------------
    def center_range(self):
        """(center[3], range) with range = max per-axis scale.

        ref: normalization.py:60-81 (calculate_center_range).
        """
        d = self.params
        center = np.array(
            [d["X_offset"], d["Y_offset"], d["Z_offset"]], dtype=np.float64
        )
        rng = max(d["X_scale"], d["Y_scale"], d["Z_scale"])
        return center, rng

    # -- transforms --------------------------------------------------------
    def normalize_xyz(self, xyz):
        center, rng = self.center_range()
        center = center.astype(np.asarray(xyz).dtype) if hasattr(xyz, "dtype") else center
        return (xyz - center) / rng

    def denormalize_xyz(self, xyz):
        center, rng = self.center_range()
        return xyz * rng + center

    def normalize_rays(self, rays):
        """Normalize origins and near/far of a packed ray tensor.

        ref: normalization.py:19-37 (normalize_single).
        """
        _, rng = self.center_range()
        rays = set_ray_component(
            rays, "origins", self.normalize_xyz(ray_component(rays, "origins"))
        )
        rays = set_ray_component(rays, "near", ray_component(rays, "near") / rng)
        rays = set_ray_component(rays, "far", ray_component(rays, "far") / rng)
        return rays
