"""Synthetic multi-date satellite scene generator.

Produces a dataset directory in exactly the root.json layout the reference's
data_prep emits for DFC2019 scenes (ref: data_prep/processing/
step_create_root_file.py:18-163), so the full train -> eval -> DSM-MAE ->
point-cloud stack can run end-to-end without the (license-gated) DFC2019
download. Used by tests and bench.py.

Scene model:
* a heightfield over a small lat/lon window (smooth terrain + box "buildings"),
* per-class albedo (ground/water/vegetation/buildings/cars) with Lambertian
  sun shading,
* N views with different off-nadir parallax and sun angles; per-view "car"
  rectangles move between dates (the transient objects the beta head and the
  car-regularisation loss Lt exist for),
* exact linear RPCs fitted per view, bundle-adjustment-style tie points with
  jittered keypoints, a GT DSM GeoTIFF + <aoi>_DSM.txt metadata, a water CLS
  mask (value 9, DFC2019 convention), and per-view semantic CLS tifs (own /
  corrupted / no-cars variants).
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.geo import utm as geo_utm
from satnerf_torch.geo.ellipsoid import latlon_to_ecef
from satnerf_torch.geo.rpc import fit_rpc_from_projections
from satnerf_torch.io.json_io import write_json
from satnerf_torch.io.tiff import GeoProfile, epsg_for_utm, write_geotiff

LABELS = {0: "ground", 1: "water", 2: "vegetation", 3: "buildings", 4: "cars"}
_CLASS_ALBEDO = np.array(
    [
        [0.45, 0.40, 0.33],  # ground
        [0.10, 0.20, 0.35],  # water
        [0.12, 0.35, 0.10],  # vegetation
        [0.55, 0.52, 0.50],  # buildings
        [0.75, 0.10, 0.10],  # cars
    ],
    dtype=np.float32,
)

LAT0, LON0 = 30.3310, -81.6610  # Jacksonville-ish
M_PER_DEG_LAT = 110540.0
M_PER_DEG_LON = 111320.0 * np.cos(np.radians(LAT0))


class SceneModel:
    """Deterministic analytic scene: height, class and albedo over metres."""

    def __init__(self, extent_m: float = 256.0, seed: int = 0,
                 height_scale: float = 1.0) -> None:
        self.extent = extent_m
        rng = np.random.default_rng(seed)
        # gaussian terrain bumps
        self.bumps = [
            (rng.uniform(0.15, 0.85, 2) * extent_m, rng.uniform(25, 70), rng.uniform(2, 6))
            for _ in range(6)
        ]
        # box buildings: (x0, y0, w, h, height). height_scale varies the
        # built regime across scenes (the DFC2019 areas differ the same way:
        # JAX_068 is downtown high-rise, JAX_260 low residential —
        # ref README.md:33-48)
        self.boxes = [
            (
                rng.uniform(0.1, 0.8) * extent_m,
                rng.uniform(0.1, 0.8) * extent_m,
                rng.uniform(0.06, 0.15) * extent_m,
                rng.uniform(0.06, 0.15) * extent_m,
                rng.uniform(8, 22) * height_scale,
            )
            for _ in range(5)
        ]
        # circular pond
        self.pond = (np.array([0.25, 0.7]) * extent_m, 0.12 * extent_m)
        # vegetation patches
        self.veg = [
            (rng.uniform(0.1, 0.9, 2) * extent_m, rng.uniform(10, 25))
            for _ in range(8)
        ]

    def height(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        h = np.zeros_like(x, dtype=np.float64)
        for (cx, cy), sigma, amp in self.bumps:
            h += amp * np.exp(-(((x - cx) ** 2 + (y - cy) ** 2) / (2 * sigma**2)))
        for x0, y0, w, d, bh in self.boxes:
            inside = (x >= x0) & (x <= x0 + w) & (y >= y0) & (y <= y0 + d)
            h = np.where(inside, h + bh, h)
        (px, py), pr = self.pond
        h = np.where((x - px) ** 2 + (y - py) ** 2 <= pr**2, 0.0, h)
        return h

    def classes(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        cls = np.zeros(x.shape, dtype=np.int32)  # ground
        for (cx, cy), r in self.veg:
            cls = np.where((x - cx) ** 2 + (y - cy) ** 2 <= r**2, 2, cls)
        for x0, y0, w, d, _ in self.boxes:
            inside = (x >= x0) & (x <= x0 + w) & (y >= y0) & (y <= y0 + d)
            cls = np.where(inside, 3, cls)
        (px, py), pr = self.pond
        cls = np.where((x - px) ** 2 + (y - py) ** 2 <= pr**2, 1, cls)
        return cls

    def normals(self, x, y, eps: float = 1.0):
        hx = (self.height(x + eps, y) - self.height(x - eps, y)) / (2 * eps)
        hy = (self.height(x, y + eps) - self.height(x, y - eps)) / (2 * eps)
        n = np.stack([-hx, -hy, np.ones_like(hx)], axis=-1)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _cars_for_view(scene: SceneModel, view_idx: int, n_cars: int = 6):
    """Transient cars: different positions per acquisition date."""
    rng = np.random.default_rng(1000 + view_idx)
    cars = []
    for _ in range(n_cars):
        cx, cy = rng.uniform(0.05, 0.95, 2) * scene.extent
        cars.append((cx, cy, rng.uniform(3, 5), rng.uniform(2, 3)))
    return cars


def _apply_cars(x, y, cls, cars):
    for cx, cy, w, d in cars:
        inside = (np.abs(x - cx) <= w) & (np.abs(y - cy) <= d)
        cls = np.where(inside & (cls != 3), 4, cls)
    return cls


def _make_utm_frame():
    """Scene (x, y) are exact UTM metre offsets from a fixed origin, so GT DSM
    georeferencing and eval back-projection share one consistent frame."""
    e0, n0, zone_string = geo_utm.utm_from_latlon(
        np.array([LAT0]), np.array([LON0])
    )
    easting0, northing0 = float(e0[0]), float(n0[0])

    def xy_to_lonlat(x, y):
        lat, lon = geo_utm.latlon_from_utm(
            easting0 + np.asarray(x), northing0 + np.asarray(y), zone_string
        )
        return lon, lat

    def lonlat_to_xy(lon, lat):
        e, n, _ = geo_utm.utm_from_latlon(
            np.asarray(lat), np.asarray(lon), zone_string=zone_string
        )
        return e - easting0, n - northing0

    return easting0, northing0, zone_string, xy_to_lonlat, lonlat_to_xy


def generate_scene(
    out_dp: str,
    n_train: int = 4,
    n_test: int = 1,
    img_size: int = 96,
    n_tie_points: int = 300,
    aoi_name: str = "SYN_001",
    seed: int = 0,
    corrupt_labels: bool = True,
    height_scale: float = 1.0,
    sun_el_range: tuple = (35.0, 70.0),
) -> str:
    """Generate a full dataset directory; returns ``out_dp``.

    ``height_scale`` and ``sun_el_range`` vary the scene regime (building
    height band, sun-elevation band) so multi-scene workflows can mimic the
    DFC2019 areas' variety (ref README.md:33-48)."""
    scene = SceneModel(seed=seed, height_scale=height_scale)
    extent = scene.extent
    res = extent / img_size
    rng = np.random.default_rng(seed + 1)
    easting0, northing0, zone_string, _xy_to_lonlat, _lonlat_to_xy = _make_utm_frame()

    img_dp = os.path.join(out_dp, "images")
    meta_dp = os.path.join(out_dp, "metas")
    sem_dp = os.path.join(out_dp, "semantic_own")
    sem_corr_dp = os.path.join(out_dp, "semantic_own_corrupted")
    sem_nocars_dp = os.path.join(out_dp, "semantic_own_no_cars")
    for dp in (img_dp, meta_dp, sem_dp, sem_corr_dp, sem_nocars_dp):
        os.makedirs(dp, exist_ok=True)

    n_views = n_train + n_test
    # off-nadir parallax per view (m of ground shift per m of altitude)
    para = rng.uniform(-0.35, 0.35, (n_views, 2))
    sun_els = rng.uniform(sun_el_range[0], sun_el_range[1], n_views)
    sun_azs = rng.uniform(80.0, 280.0, n_views)

    # tie points on the surface (shared across views)
    tp_x = rng.uniform(0.05, 0.95, n_tie_points) * extent
    tp_y = rng.uniform(0.05, 0.95, n_tie_points) * extent
    tp_h = scene.height(tp_x, tp_y)
    tp_lon, tp_lat = _xy_to_lonlat(tp_x, tp_y)
    tp_ecef = np.stack(latlon_to_ecef(tp_lat, tp_lon, tp_h), axis=1)

    names = []
    alt_max = float(scene.height(
        *np.meshgrid(np.linspace(0, extent, 64), np.linspace(0, extent, 64))
    ).max())

    for v in range(n_views):
        name = f"{aoi_name}_{v:03d}_RGB"
        names.append(name)
        dx, dy = para[v]

        def project(lon, lat, alt):
            """Analytic pushbroom-like projection for this view."""
            x, y = _lonlat_to_xy(lon, lat)
            col = (x + dx * np.asarray(alt)) / res
            row = (extent - (y + dy * np.asarray(alt))) / res
            return col, row

        # render: invert the projection per pixel by fixed-point iteration
        cols, rows = np.meshgrid(np.arange(img_size) + 0.5, np.arange(img_size) + 0.5)
        gx = cols * res
        gy = extent - rows * res
        alt = np.zeros_like(gx)
        for _ in range(8):
            sx = gx - dx * alt
            sy = gy - dy * alt
            alt = scene.height(sx, sy)
        sx, sy = gx - dx * alt, gy - dy * alt

        cls = scene.classes(sx, sy)
        cars = _cars_for_view(scene, v)
        cls = _apply_cars(sx, sy, cls, cars)

        albedo = _CLASS_ALBEDO[cls]
        normals = scene.normals(sx, sy)
        sun = np.array(
            [
                np.sin(np.radians(sun_azs[v])) * np.cos(np.radians(sun_els[v])),
                np.cos(np.radians(sun_azs[v])) * np.cos(np.radians(sun_els[v])),
                np.sin(np.radians(sun_els[v])),
            ]
        )
        shade = np.clip(normals @ sun, 0.15, 1.0)[..., None]
        sky = 0.25
        img = albedo * (shade * 0.85 + sky * 0.15)
        img_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)

        # fit an RPC to the analytic projection over the validity volume
        glon = rng.uniform(0, extent, 800)
        glat = rng.uniform(0, extent, 800)
        galt = rng.uniform(-5.0, alt_max + 10.0, 800)
        flon, flat = _xy_to_lonlat(glon, glat)
        fcol, frow = project(flon, flat, galt)
        rpc = fit_rpc_from_projections(flon, flat, galt, fcol, frow, degree_terms=10)

        write_geotiff(
            os.path.join(img_dp, f"{name}.tif"),
            np.moveaxis(img_u8, -1, 0),
            GeoProfile(img_size, img_size, 3, "uint8", rpc=rpc),
        )

        # semantic labels (own, corrupted, no-cars)
        cls_u8 = cls.astype(np.uint8)[None]
        prof1 = GeoProfile(img_size, img_size, 1, "uint8", rpc=rpc)
        write_geotiff(os.path.join(sem_dp, f"{aoi_name}_{v:03d}_CLS.tif"), cls_u8, prof1)
        nocars = np.where(cls_u8 == 4, 0, cls_u8).astype(np.uint8)
        write_geotiff(
            os.path.join(sem_nocars_dp, f"{aoi_name}_{v:03d}_CLS.tif"), nocars, prof1
        )
        if corrupt_labels:
            corr = cls_u8.copy()
            crng = np.random.default_rng(2000 + v)
            flip = crng.uniform(size=corr.shape) < 0.08
            corr = np.where(
                flip, crng.integers(0, 5, corr.shape).astype(np.uint8), corr
            )
            write_geotiff(
                os.path.join(sem_corr_dp, f"{aoi_name}_{v:03d}_CLS.tif"), corr, prof1
            )

        # keypoints: project tie points, jitter for nonzero reprojection error
        kp_col, kp_row = project(tp_lon, tp_lat, tp_h)
        in_img = (
            (kp_col >= 0) & (kp_col < img_size) & (kp_row >= 0) & (kp_row < img_size)
        )
        idx = np.nonzero(in_img)[0]
        jitter = np.random.default_rng(3000 + v).normal(0, 0.3, (idx.size, 2))
        pts2d = np.stack([kp_col[idx], kp_row[idx]], axis=1) + jitter

        meta = {
            "img": f"{name}.tif",
            "width": img_size,
            "height": img_size,
            "min_alt": -5.0,
            "max_alt": alt_max + 10.0,
            "sun_elevation": float(sun_els[v]),
            "sun_azimuth": float(sun_azs[v]),
            "acquisition_date": f"2020-0{(v % 9) + 1}-15",
            "rpc": rpc.to_dict(),
            "geojson": {
                "center": [LON0 + extent / 2 / M_PER_DEG_LON,
                           LAT0 + extent / 2 / M_PER_DEG_LAT],
            },
            "keypoints": {
                "2d_coordinates": pts2d.tolist(),
                "pts3d_indices": idx.tolist(),
            },
        }
        write_json(os.path.join(meta_dp, f"{name}.json"), meta)

    np.save(os.path.join(out_dp, "pts3d.npy"), tp_ecef)

    # GT DSM over the scene in UTM (0.5 m like the DFC2019 lidar rasters,
    # so the reference's equal-resolution MAE crop semantics hold)
    dsm_res = 0.5
    dsm_size = int(extent / dsm_res)
    gx, gy = np.meshgrid(
        (np.arange(dsm_size) + 0.5) * dsm_res,
        extent - (np.arange(dsm_size) + 0.5) * dsm_res,
    )
    dsm = scene.height(gx, gy).astype(np.float32)
    dsm_cls = scene.classes(gx, gy)
    water_mask = np.where(dsm_cls == 1, 9, 0).astype(np.uint8)  # DFC2019: water==9

    transform = (dsm_res, dsm_res, easting0, northing0 + extent)
    epsg = epsg_for_utm(zone_string)
    write_geotiff(
        os.path.join(out_dp, f"{aoi_name}_DSM.tif"),
        dsm[None],
        GeoProfile(dsm_size, dsm_size, 1, "float32", transform=transform,
                   epsg=epsg, nodata=float("nan")),
    )
    write_geotiff(
        os.path.join(out_dp, f"{aoi_name}_CLS.tif"),
        water_mask[None],
        GeoProfile(dsm_size, dsm_size, 1, "uint8", transform=transform, epsg=epsg),
    )
    # DSM metadata txt: xoff yoff(size lower-left) size resolution
    # (ref: eval/utils/dsm.py:121-127 conventions)
    with open(os.path.join(out_dp, f"{aoi_name}_DSM.txt"), "w") as f:
        f.write(f"{easting0}\n{northing0}\n{dsm_size}\n{dsm_res}\n")

    root = {
        "aoi_name": aoi_name,
        "img_dp": "images",
        "meta_dp": "metas",
        "dsm_txt_fp": f"{aoi_name}_DSM.txt",
        "dsm_tif_fp": f"{aoi_name}_DSM.tif",
        "dsm_cls_fp": f"{aoi_name}_CLS.tif",
        "zone_string": zone_string,
        "points3d_fp": "pts3d.npy",
        "train_split": [f"{n}.json" for n in names[:n_train]],
        "test_split": [f"{n}.json" for n in names[n_train:]],
        "dsm_center_lons": LON0 + extent / 2 / M_PER_DEG_LON,
        "dsm_center_lats": LAT0 + extent / 2 / M_PER_DEG_LAT,
        "semantic_dp_own": "semantic_own",
        "semantic_dp_own_corrupted": "semantic_own_corrupted",
        "semantic_dp_own_no_cars": "semantic_own_no_cars",
        "semantic_cls_labels": {str(k): v for k, v in LABELS.items()},
    }
    write_json(os.path.join(out_dp, "root.json"), root)
    return out_dp
