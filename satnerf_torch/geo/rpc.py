"""Rational Polynomial Camera (RPC) model.

Self-contained replacement for the ``rpcm`` dependency used by the reference
(ref: baseline/components/camera_models.py:12-36, framework/util/sat_utils.py:6-24):

* 20-term cubic rational polynomials in the standard RPC00B term order used by
  rpcm/GDAL, so coefficient dicts from DFC2019 meta JSONs ("rpcm" dict format)
  evaluate identically;
* ``projection(lon, lat, alt) -> (col, row)``;
* ``localization(col, row, alt) -> (lon, lat)`` via a vectorised Newton
  iteration with finite-difference Jacobian (fixed iteration count, so the same
  routine is jit-compatible with jnp for on-device ray generation);
* ``rescale_rpc`` for image down/up-sampling;
* serialisation to/from the rpcm-style dict and to/from the 92-double GeoTIFF
  RPCCoefficient tag layout.

Polynomial variable convention (matches rpcm): ``apply_poly(poly, x, y, z)``
with x=normalised latitude, y=normalised longitude, z=normalised altitude for
projection.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np


def apply_poly(poly, x, y, z, xp=np):
    """Evaluate a 20-term cubic RPC polynomial.

    Term order is the standard RPC00B order (same as rpcm's apply_poly).
    """
    out = poly[0] * xp.ones_like(x)
    out = out + poly[1] * y + poly[2] * x + poly[3] * z
    out = out + poly[4] * y * x + poly[5] * y * z + poly[6] * x * z
    out = out + poly[7] * y * y + poly[8] * x * x + poly[9] * z * z
    out = out + poly[10] * x * y * z
    out = out + poly[11] * y * y * y
    out = out + poly[12] * y * x * x + poly[13] * y * z * z + poly[14] * y * y * x
    out = out + poly[15] * x * x * x
    out = out + poly[16] * x * z * z + poly[17] * y * y * z + poly[18] * x * x * z
    out = out + poly[19] * z * z * z
    return out


def apply_rfm(num, den, x, y, z, xp=np):
    """Evaluate a rational function model num(P)/den(P)."""
    return apply_poly(num, x, y, z, xp=xp) / apply_poly(den, x, y, z, xp=xp)


@dataclass
class RPCModel:
    """RPC camera: image (col,row) <-> ground (lon,lat,alt)."""

    row_offset: float
    col_offset: float
    lat_offset: float
    lon_offset: float
    alt_offset: float
    row_scale: float
    col_scale: float
    lat_scale: float
    lon_scale: float
    alt_scale: float
    row_num: np.ndarray = field(default_factory=lambda: np.zeros(20))
    row_den: np.ndarray = field(default_factory=lambda: _one_poly())
    col_num: np.ndarray = field(default_factory=lambda: np.zeros(20))
    col_den: np.ndarray = field(default_factory=lambda: _one_poly())

    def __post_init__(self):
        self.row_num = np.asarray(self.row_num, dtype=np.float64)
        self.row_den = np.asarray(self.row_den, dtype=np.float64)
        self.col_num = np.asarray(self.col_num, dtype=np.float64)
        self.col_den = np.asarray(self.col_den, dtype=np.float64)

    # -- forward -----------------------------------------------------------
    def projection(self, lon, lat, alt, xp=np):
        """(lon, lat, alt) -> (col, row). ref: rpcm RPCModel.projection."""
        nlon = (xp.asarray(lon) - self.lon_offset) / self.lon_scale
        nlat = (xp.asarray(lat) - self.lat_offset) / self.lat_scale
        nalt = (xp.asarray(alt) - self.alt_offset) / self.alt_scale
        col = apply_rfm(self.col_num, self.col_den, nlat, nlon, nalt, xp=xp)
        row = apply_rfm(self.row_num, self.row_den, nlat, nlon, nalt, xp=xp)
        col = col * self.col_scale + self.col_offset
        row = row * self.row_scale + self.row_offset
        return col, row

    # -- inverse -----------------------------------------------------------
    def localization(self, col, row, alt, n_iter: int = 15, xp=np):
        """(col, row, alt) -> (lon, lat) at the given altitude.

        Newton iteration on the normalised forward model with a
        finite-difference 2x2 Jacobian. Fixed iteration count keeps the
        routine shape-static (jit/vmap-friendly); RPCs are near-affine so
        ~10 iterations reach <1e-10 in normalised units.
        ref behavior: rpcm localization_iterative (used by
        baseline/components/rays.py:34-73 for ray construction).
        """
        ncol = (xp.asarray(col) - self.col_offset) / self.col_scale
        nrow = (xp.asarray(row) - self.row_offset) / self.row_scale
        nalt = (xp.asarray(alt) - self.alt_offset) / self.alt_scale

        # initial guess: centre of the validity domain
        lon = xp.zeros_like(ncol)
        lat = xp.zeros_like(ncol)
        eps = 1e-4

        def forward(nlat, nlon):
            c = apply_rfm(self.col_num, self.col_den, nlat, nlon, nalt, xp=xp)
            r = apply_rfm(self.row_num, self.row_den, nlat, nlon, nalt, xp=xp)
            return c, r

        for _ in range(n_iter):
            c0, r0 = forward(lat, lon)
            c_dlon, r_dlon = forward(lat, lon + eps)
            c_dlat, r_dlat = forward(lat + eps, lon)
            # Jacobian entries d(col,row)/d(lon,lat)
            a11 = (c_dlon - c0) / eps
            a12 = (c_dlat - c0) / eps
            a21 = (r_dlon - r0) / eps
            a22 = (r_dlat - r0) / eps
            det = a11 * a22 - a12 * a21
            ec = ncol - c0
            er = nrow - r0
            lon = lon + (a22 * ec - a12 * er) / det
            lat = lat + (a11 * er - a21 * ec) / det

        lon = lon * self.lon_scale + self.lon_offset
        lat = lat * self.lat_scale + self.lat_offset
        return lon, lat

    # -- serialisation -----------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "RPCModel":
        """Build from the rpcm-style dict stored in dataset meta JSONs."""
        return cls(
            row_offset=float(d["row_offset"]),
            col_offset=float(d["col_offset"]),
            lat_offset=float(d["lat_offset"]),
            lon_offset=float(d["lon_offset"]),
            alt_offset=float(d["alt_offset"]),
            row_scale=float(d["row_scale"]),
            col_scale=float(d["col_scale"]),
            lat_scale=float(d["lat_scale"]),
            lon_scale=float(d["lon_scale"]),
            alt_scale=float(d["alt_scale"]),
            row_num=np.asarray(d["row_num"], dtype=np.float64),
            row_den=np.asarray(d["row_den"], dtype=np.float64),
            col_num=np.asarray(d["col_num"], dtype=np.float64),
            col_den=np.asarray(d["col_den"], dtype=np.float64),
        )

    def to_dict(self) -> dict:
        return {
            "row_offset": self.row_offset,
            "col_offset": self.col_offset,
            "lat_offset": self.lat_offset,
            "lon_offset": self.lon_offset,
            "alt_offset": self.alt_offset,
            "row_scale": self.row_scale,
            "col_scale": self.col_scale,
            "lat_scale": self.lat_scale,
            "lon_scale": self.lon_scale,
            "alt_scale": self.alt_scale,
            "row_num": self.row_num.tolist(),
            "row_den": self.row_den.tolist(),
            "col_num": self.col_num.tolist(),
            "col_den": self.col_den.tolist(),
        }

    @classmethod
    def from_geotiff_tag(cls, values) -> "RPCModel":
        """Build from the 92-double GeoTIFF RPCCoefficient tag (50844).

        Layout: ERR_BIAS, ERR_RAND, LINE_OFF, SAMP_OFF, LAT_OFF, LONG_OFF,
        HEIGHT_OFF, LINE_SCALE, SAMP_SCALE, LAT_SCALE, LONG_SCALE,
        HEIGHT_SCALE, LINE_NUM(20), LINE_DEN(20), SAMP_NUM(20), SAMP_DEN(20).
        """
        v = np.asarray(values, dtype=np.float64)
        assert v.shape[0] == 92, f"RPC tag must have 92 doubles, got {v.shape[0]}"
        return cls(
            row_offset=v[2],
            col_offset=v[3],
            lat_offset=v[4],
            lon_offset=v[5],
            alt_offset=v[6],
            row_scale=v[7],
            col_scale=v[8],
            lat_scale=v[9],
            lon_scale=v[10],
            alt_scale=v[11],
            row_num=v[12:32],
            row_den=v[32:52],
            col_num=v[52:72],
            col_den=v[72:92],
        )

    @classmethod
    def from_rpc_file(cls, fp: str) -> "RPCModel":
        """Parse an IKONOS-style RPC text file (``*.rpc`` / ``*.rpc_adj``).

        This is the format sat-bundleadjust writes its adjusted cameras in
        (ref: data_prep/processing/step_finish_meta_extraction.py:57-62 reads
        them with rpcm.rpc_from_rpc_file): ``KEY: value [unit]`` lines with
        LINE_*/SAMP_*/LAT_*/LONG_*/HEIGHT_* offsets+scales and the four
        20-coefficient polynomials as ``LINE_NUM_COEFF_1`` .. ``SAMP_DEN_COEFF_20``.
        """
        vals: dict[str, float] = {}
        with open(fp) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, rest = line.split(":", 1)
                try:
                    vals[key.strip().upper()] = float(rest.split()[0])
                except (ValueError, IndexError):
                    continue

        def poly(prefix: str) -> np.ndarray:
            return np.array(
                [vals[f"{prefix}_{i}"] for i in range(1, 21)], dtype=np.float64
            )

        return cls(
            row_offset=vals["LINE_OFF"],
            col_offset=vals["SAMP_OFF"],
            lat_offset=vals["LAT_OFF"],
            lon_offset=vals["LONG_OFF"],
            alt_offset=vals["HEIGHT_OFF"],
            row_scale=vals["LINE_SCALE"],
            col_scale=vals["SAMP_SCALE"],
            lat_scale=vals["LAT_SCALE"],
            lon_scale=vals["LONG_SCALE"],
            alt_scale=vals["HEIGHT_SCALE"],
            row_num=poly("LINE_NUM_COEFF"),
            row_den=poly("LINE_DEN_COEFF"),
            col_num=poly("SAMP_NUM_COEFF"),
            col_den=poly("SAMP_DEN_COEFF"),
        )

    def to_rpc_file(self, fp: str) -> None:
        """Write the IKONOS-style RPC text format from_rpc_file reads."""
        units = {
            "LINE_OFF": "pixels", "SAMP_OFF": "pixels",
            "LAT_OFF": "degrees", "LONG_OFF": "degrees",
            "HEIGHT_OFF": "meters",
            "LINE_SCALE": "pixels", "SAMP_SCALE": "pixels",
            "LAT_SCALE": "degrees", "LONG_SCALE": "degrees",
            "HEIGHT_SCALE": "meters",
        }
        scalars = {
            "LINE_OFF": self.row_offset, "SAMP_OFF": self.col_offset,
            "LAT_OFF": self.lat_offset, "LONG_OFF": self.lon_offset,
            "HEIGHT_OFF": self.alt_offset,
            "LINE_SCALE": self.row_scale, "SAMP_SCALE": self.col_scale,
            "LAT_SCALE": self.lat_scale, "LONG_SCALE": self.lon_scale,
            "HEIGHT_SCALE": self.alt_scale,
        }
        polys = {
            "LINE_NUM_COEFF": self.row_num, "LINE_DEN_COEFF": self.row_den,
            "SAMP_NUM_COEFF": self.col_num, "SAMP_DEN_COEFF": self.col_den,
        }
        with open(fp, "w") as f:
            for key, v in scalars.items():
                f.write(f"{key}: {v:.12f} {units[key]}\n")
            for prefix, coeffs in polys.items():
                for i, c in enumerate(coeffs, start=1):
                    f.write(f"{prefix}_{i}: {c:.12e}\n")

    def to_geotiff_tag(self) -> np.ndarray:
        v = np.zeros(92, dtype=np.float64)
        v[0] = -1.0  # ERR_BIAS unknown
        v[1] = -1.0  # ERR_RAND unknown
        v[2] = self.row_offset
        v[3] = self.col_offset
        v[4] = self.lat_offset
        v[5] = self.lon_offset
        v[6] = self.alt_offset
        v[7] = self.row_scale
        v[8] = self.col_scale
        v[9] = self.lat_scale
        v[10] = self.lon_scale
        v[11] = self.alt_scale
        v[12:32] = self.row_num
        v[32:52] = self.row_den
        v[52:72] = self.col_num
        v[72:92] = self.col_den
        return v


def _one_poly() -> np.ndarray:
    p = np.zeros(20)
    p[0] = 1.0
    return p


def rescale_rpc(rpc: RPCModel, alpha: float) -> RPCModel:
    """Scale an RPC model to match a resampled image (x alpha).

    ref: framework/util/sat_utils.py:6-24 — scales the image-space offsets and
    scales by alpha, leaving ground-space terms untouched.
    """
    out = copy.deepcopy(rpc)
    out.row_offset = rpc.row_offset * float(alpha)
    out.col_offset = rpc.col_offset * float(alpha)
    out.row_scale = rpc.row_scale * float(alpha)
    out.col_scale = rpc.col_scale * float(alpha)
    return out


def fit_rpc_from_projections(
    lons, lats, alts, cols, rows, degree_terms: int = 10
) -> RPCModel:
    """Fit an RPC (numerator-only, denominator=1) to point correspondences.

    Used by the synthetic-scene generator and the data-prep adapter when a
    physical camera model needs an RPC approximation. A linear least-squares
    fit over the first ``degree_terms`` polynomial terms (default: all terms
    up to second order) with unit denominators — adequate for the smooth,
    near-affine viewing geometry of satellite pushbroom cameras over small
    scenes.
    """
    lons = np.asarray(lons, dtype=np.float64)
    lats = np.asarray(lats, dtype=np.float64)
    alts = np.asarray(alts, dtype=np.float64)
    cols = np.asarray(cols, dtype=np.float64)
    rows = np.asarray(rows, dtype=np.float64)

    def scale_offset(v):
        off = (v.max() + v.min()) / 2.0
        sc = max((v.max() - v.min()) / 2.0, 1e-9)
        return off, sc

    lat_off, lat_sc = scale_offset(lats)
    lon_off, lon_sc = scale_offset(lons)
    alt_off, alt_sc = scale_offset(alts)
    row_off, row_sc = scale_offset(rows)
    col_off, col_sc = scale_offset(cols)

    x = (lats - lat_off) / lat_sc
    y = (lons - lon_off) / lon_sc
    z = (alts - alt_off) / alt_sc

    # design matrix over the RPC term basis
    terms = [
        np.ones_like(x), y, x, z, y * x, y * z, x * z, y * y, x * x, z * z,
        x * y * z, y**3, y * x * x, y * z * z, y * y * x, x**3, x * z * z,
        y * y * z, x * x * z, z**3,
    ]
    A = np.stack(terms[:degree_terms], axis=1)

    def fit(target):
        coefs, *_ = np.linalg.lstsq(A, target, rcond=None)
        poly = np.zeros(20)
        poly[:degree_terms] = coefs
        return poly

    col_num = fit((cols - col_off) / col_sc)
    row_num = fit((rows - row_off) / row_sc)

    return RPCModel(
        row_offset=row_off,
        col_offset=col_off,
        lat_offset=lat_off,
        lon_offset=lon_off,
        alt_offset=alt_off,
        row_scale=row_sc,
        col_scale=col_sc,
        lat_scale=lat_sc,
        lon_scale=lon_sc,
        alt_scale=alt_sc,
        row_num=row_num,
        col_num=col_num,
    )
