"""Packed ray tensor layout (port of ``satnerf_tpu/core/rays.py``).

* ``rays``   (N, 8)  float32: origin[0:3], direction[3:6], near[6:7], far[7:8]
* ``extras`` (N, 4)  float32: sun_direction[0:3], ts[3:4]

The accessors work on numpy arrays and torch tensors alike. RPC ray
construction (``build_rays_from_rpc``) is not ported yet.
"""

from __future__ import annotations

import numpy as np

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
