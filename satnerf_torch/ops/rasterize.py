"""Point-cloud -> DSM rasterization (plyflatten replacement).

ref: eval/utils/dsm.py:74-78 — plyflatten(cloud, xoff, yoff, resolution,
xsize, ysize, radius=1, sigma=inf) = per-cell average of all points within
`radius` cells. Two implementations:

* C++ scatter (ops/native.py) — default host path;
* numpy bucketed scatter-add fallback.
"""

from __future__ import annotations

import numpy as np

from satnerf_torch.ops import native


def rasterize_mean(
    cloud: np.ndarray,
    xoff: float,
    yoff: float,
    resolution: float,
    xsize: int,
    ysize: int,
    radius: int = 1,
) -> np.ndarray:
    """(n, 3) UTM cloud -> (ysize, xsize) mean-altitude grid (nan = empty).

    Grid convention matches the reference DSM rasters: row 0 is the NORTH
    edge at ``yoff`` (north-up, ref: eval/utils/dsm.py:96-100 transform).
    """
    cloud = np.ascontiguousarray(cloud, dtype=np.float64)
    lib = native.get_lib()
    acc = np.zeros((ysize, xsize), dtype=np.float64)
    cnt = np.zeros((ysize, xsize), dtype=np.float64)
    if lib is not None:
        lib.sn_rasterize_mean(
            native.as_double_ptr(cloud), cloud.shape[0],
            float(xoff), float(yoff), float(resolution),
            int(xsize), int(ysize), int(radius),
            native.as_double_ptr(acc), native.as_double_ptr(cnt),
        )
    else:
        finite = np.isfinite(cloud).all(axis=1)
        col = np.where(finite, (cloud[:, 0] - xoff) / resolution, -1.0)
        row = np.where(finite, (yoff - cloud[:, 1]) / resolution, -1.0)
        z = cloud[:, 2]
        c0 = np.floor(col).astype(np.int64)
        r0 = np.floor(row).astype(np.int64)
        for dr in range(-radius, radius + 1):
            for dc in range(-radius, radius + 1):
                rr, cc = r0 + dr, c0 + dc
                ok = (
                    (rr >= 0) & (rr < ysize) & (cc >= 0) & (cc < xsize)
                    & finite
                )
                if radius > 0:  # radius==0 -> exactly the containing cell
                    dist2 = ((cc + 0.5) - col) ** 2 + ((rr + 0.5) - row) ** 2
                    ok &= dist2 <= radius * radius + 0.25
                np.add.at(acc, (rr[ok], cc[ok]), z[ok])
                np.add.at(cnt, (rr[ok], cc[ok]), 1.0)
    with np.errstate(invalid="ignore"):
        out = acc / cnt
    out[cnt == 0] = np.nan
    return out

