"""WGS84 geodetic <-> geocentric (ECEF) conversions.

Closed-form conversions matching the reference's custom implementation
(ref: framework/util/conversions.py:43-83) so that scene coordinate frames are
bit-comparable: forward uses the standard prime-vertical radius formula, the
inverse uses the single-pass Bowring-style approximation (NOT an iterative
solver) — the reference's inverse is approximate, and MAE/DSM numbers depend on
reproducing exactly that approximation.

Both numpy (float64, host) and jnp (device) variants are provided via the
``xp`` module argument; public wrappers pick numpy by default.
"""

from __future__ import annotations

import numpy as np

# WGS84 constants
_A = 6378137.0
_FINV = 298.257223563
_F = 1.0 / _FINV
_E2 = 1.0 - (1.0 - _F) * (1.0 - _F)  # first eccentricity squared
_E = 8.1819190842622e-2  # value used by the reference inverse


def latlon_to_ecef(lat, lon, alt, xp=np):
    """Geodetic (deg, deg, m) -> ECEF (m). ref: conversions.py:43-59."""
    rad_lat = lat * (xp.pi / 180.0)
    rad_lon = lon * (xp.pi / 180.0)
    v = _A / xp.sqrt(1.0 - _E2 * xp.sin(rad_lat) * xp.sin(rad_lat))
    x = (v + alt) * xp.cos(rad_lat) * xp.cos(rad_lon)
    y = (v + alt) * xp.cos(rad_lat) * xp.sin(rad_lon)
    z = (v * (1.0 - _E2) + alt) * xp.sin(rad_lat)
    return x, y, z


def ecef_to_latlon(x, y, z, xp=np):
    """ECEF (m) -> geodetic (deg, deg, m), single-pass approximation.

    ref: conversions.py:62-83 (same constants and formula shape).
    """
    asq = _A**2
    esq = _E**2
    b = xp.sqrt(asq * (1.0 - esq))
    bsq = b**2
    ep = xp.sqrt((asq - bsq) / bsq)
    p = xp.sqrt(x**2 + y**2)
    th = xp.arctan2(_A * z, b * p)
    lon = xp.arctan2(y, x)
    lat = xp.arctan2(
        z + (ep**2) * b * (xp.sin(th) ** 3),
        p - esq * _A * (xp.cos(th) ** 3),
    )
    n = _A / xp.sqrt(1.0 - esq * (xp.sin(lat) ** 2))
    alt = p / xp.cos(lat) - n
    lon = lon * 180.0 / xp.pi
    lat = lat * 180.0 / xp.pi
    return lat, lon, alt
