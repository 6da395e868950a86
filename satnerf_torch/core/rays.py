"""Packed ray tensor layout (port of ``satnerf_tpu/core/rays.py``).

* ``rays``   (N, 8)  float32: origin[0:3], direction[3:6], near[6:7], far[7:8]
* ``extras`` (N, 4)  float32: sun_direction[0:3], ts[3:4]

The accessors work on numpy arrays and torch tensors alike. RPC ray
construction (``build_rays_from_rpc``) runs on the host in float64 numpy, as
in the reference: localize every pixel on the max-altitude plane (near
points) and the min-altitude plane (far points), convert both to the scene
frame, set origin = near point, direction = (far - near) / |far - near|,
near = 0, far = |far - near|; the packed result is float32.
"""

from __future__ import annotations

import numpy as np

from satnerf_torch.geo.coordinate_systems import BaseCoordinateSystem
from satnerf_torch.geo.rpc import RPCModel

RAY_DIM = 8
EXTRAS_DIM = 4

_RAY_SLICES = {
    "origins": (0, 3),
    "directions": (3, 6),
    "near": (6, 7),
    "far": (7, 8),
}
_EXTRAS_SLICES = {
    "sun_directions": (0, 3),
    "ts": (3, 4),
}


def _lookup(table: dict, name: str) -> tuple[int, int]:
    # prefix match in either direction: "origin"/"origins", "dir"/"directions",
    # "fars"/"far", "sun_d"/"sun_directions" all resolve
    for key, span in table.items():
        if key.startswith(name) or name.startswith(key):
            return span
    raise KeyError(f"unknown component name: {name}")


def ray_component(rays, name: str):
    """Named column access into a packed ray tensor."""
    start, end = _lookup(_RAY_SLICES, name)
    return rays[..., start:end]


def set_ray_component(rays, name: str, value):
    """Functional update of a ray component (returns a new array/tensor)."""
    start, end = _lookup(_RAY_SLICES, name)
    out = rays.copy() if isinstance(rays, np.ndarray) else rays.clone()
    out[..., start:end] = value
    return out


def extras_component(extras, name: str):
    """Named column access into the extras tensor."""
    start, end = _lookup(_EXTRAS_SLICES, name)
    return extras[..., start:end]


def construct_sun_dir(
    sun_elevation_deg: float, sun_azimuth_deg: float, n_rays: int
) -> np.ndarray:
    """Unit sun-direction vector tiled per ray:
    [sin(az)cos(el), cos(az)cos(el), sin(el)]."""
    sun_el = np.radians(sun_elevation_deg)
    sun_az = np.radians(sun_azimuth_deg)
    sun_d = np.array(
        [
            np.sin(sun_az) * np.cos(sun_el),
            np.cos(sun_az) * np.cos(sun_el),
            np.sin(sun_el),
        ],
        dtype=np.float64,
    )
    return np.tile(sun_d, (n_rays, 1)).astype(np.float32)


def build_rays_from_rpc(
    camera: RPCModel,
    coordinate_system: BaseCoordinateSystem,
    rows: np.ndarray,
    cols: np.ndarray,
    min_alt: float,
    max_alt: float,
) -> np.ndarray:
    """Construct packed (N, 8) rays through the given pixels."""
    rows = np.asarray(rows, dtype=np.float64).ravel()
    cols = np.asarray(cols, dtype=np.float64).ravel()
    min_alts = np.full(cols.shape, float(min_alt))
    max_alts = np.full(cols.shape, float(max_alt))

    # points of maximum altitude are closest to the camera
    lons, lats = camera.localization(cols, rows, max_alts)
    x, y, z = coordinate_system.from_latlon(lats, lons, max_alts)
    xyz_near = np.stack([x, y, z], axis=1)

    lons, lats = camera.localization(cols, rows, min_alts)
    x, y, z = coordinate_system.from_latlon(lats, lons, min_alts)
    xyz_far = np.stack([x, y, z], axis=1)

    d = xyz_far - xyz_near
    norms = np.linalg.norm(d, axis=1, keepdims=True)
    rays_d = d / norms

    rays = np.concatenate(
        [xyz_near, rays_d, np.zeros_like(norms), norms], axis=1
    )
    return rays.astype(np.float32)
