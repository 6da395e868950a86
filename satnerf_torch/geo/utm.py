"""UTM <-> geodetic conversions (WGS84, Transverse Mercator series).

Self-contained implementation of the standard USGS/Snyder series expansion
(the same math the ``utm`` PyPI package implements), replacing the reference's
third-party dependency (ref: framework/util/conversions.py:107-150 uses
``utm.from_latlon``/``utm.to_latlon``). Accuracy is sub-millimetre within a
zone, verified by round-trip tests and known reference vectors.

Vectorised over numpy arrays; an ``xp`` argument allows jnp for device use.
"""

from __future__ import annotations

import numpy as np

K0 = 0.9996
R = 6378137.0
E = 0.00669438  # WGS84 first eccentricity squared
E2 = E * E
E3 = E2 * E
E_P2 = E / (1.0 - E)

_SQRT_E = np.sqrt(1.0 - E)
_E = (1.0 - _SQRT_E) / (1.0 + _SQRT_E)
_E2 = _E * _E
_E3 = _E2 * _E
_E4 = _E3 * _E
_E5 = _E4 * _E

M1 = 1.0 - E / 4.0 - 3.0 * E2 / 64.0 - 5.0 * E3 / 256.0
M2 = 3.0 * E / 8.0 + 3.0 * E2 / 32.0 + 45.0 * E3 / 1024.0
M3 = 15.0 * E2 / 256.0 + 45.0 * E3 / 1024.0
M4 = 35.0 * E3 / 3072.0

P2 = 3.0 / 2.0 * _E - 27.0 / 32.0 * _E3 + 269.0 / 512.0 * _E5
P3 = 21.0 / 16.0 * _E2 - 55.0 / 32.0 * _E4
P4 = 151.0 / 96.0 * _E3 - 417.0 / 128.0 * _E5
P5 = 1097.0 / 512.0 * _E4

ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWXX"


def latlon_to_zone_number(lat: float, lon: float) -> int:
    """UTM zone number for a lat/lon, with Norway/Svalbard exceptions."""
    if 56.0 <= lat < 64.0 and 3.0 <= lon < 12.0:
        return 32
    if 72.0 <= lat <= 84.0 and lon >= 0.0:
        if lon < 9.0:
            return 31
        if lon < 21.0:
            return 33
        if lon < 33.0:
            return 35
        if lon < 42.0:
            return 37
    return int((lon + 180.0) / 6.0) % 60 + 1


def latitude_to_zone_letter(lat: float) -> str:
    if -80.0 <= lat <= 84.0:
        return ZONE_LETTERS[int(lat + 80.0) >> 3]
    raise ValueError(f"latitude {lat} outside UTM range")


def latlon_to_zone_string(lat: float, lon: float) -> str:
    return str(latlon_to_zone_number(lat, lon)) + latitude_to_zone_letter(lat)


def split_zone_string(zone_string: str) -> tuple[int, str]:
    """'17R' -> (17, 'R'). ref: conversions.py:143-144."""
    return int(zone_string[:-1]), zone_string[-1]


def zonestring_to_hemisphere(zone_string: str) -> str:
    """'17R' -> '17N' / '17S'. ref: conversions.py:147-153."""
    zone_number, zone_letter = split_zone_string(zone_string)
    return str(zone_number) + ("N" if zone_letter >= "N" else "S")


def _central_longitude(zone_number) -> float:
    return (zone_number - 1) * 6.0 - 180.0 + 3.0


def utm_from_latlon(lats, lons, zone_string: str | None = None, xp=np):
    """Geodetic -> UTM easting/northing.

    Returns ``(eastings, northings, zone_string)``; if ``zone_string`` is not
    given it is derived from the first point (the reference forces all points
    of a scene into a single zone the same way).
    ref: conversions.py:118-127 (utm.from_latlon wrapper).
    """
    lats = xp.asarray(lats)
    lons = xp.asarray(lons)
    if zone_string is None:
        lat0 = float(np.ravel(np.asarray(lats))[0])
        lon0 = float(np.ravel(np.asarray(lons))[0])
        zone_string = latlon_to_zone_string(lat0, lon0)
    zone_number, zone_letter = split_zone_string(zone_string)
    northern = zone_letter >= "N"

    lat_rad = xp.radians(lats)
    lat_sin = xp.sin(lat_rad)
    lat_cos = xp.cos(lat_rad)
    lat_tan = lat_sin / lat_cos
    lat_tan2 = lat_tan * lat_tan
    lat_tan4 = lat_tan2 * lat_tan2

    lon_rad = xp.radians(lons)
    central_lon_rad = xp.radians(_central_longitude(zone_number))

    n = R / xp.sqrt(1.0 - E * lat_sin**2)
    c = E_P2 * lat_cos**2

    a = lat_cos * _mod_angle(lon_rad - central_lon_rad, xp)
    a2 = a * a
    a3 = a2 * a
    a4 = a3 * a
    a5 = a4 * a
    a6 = a5 * a

    m = R * (
        M1 * lat_rad
        - M2 * xp.sin(2.0 * lat_rad)
        + M3 * xp.sin(4.0 * lat_rad)
        - M4 * xp.sin(6.0 * lat_rad)
    )

    easting = (
        K0
        * n
        * (
            a
            + a3 / 6.0 * (1.0 - lat_tan2 + c)
            + a5 / 120.0 * (5.0 - 18.0 * lat_tan2 + lat_tan4 + 72.0 * c - 58.0 * E_P2)
        )
        + 500000.0
    )
    northing = K0 * (
        m
        + n
        * lat_tan
        * (
            a2 / 2.0
            + a4 / 24.0 * (5.0 - lat_tan2 + 9.0 * c + 4.0 * c**2)
            + a6
            / 720.0
            * (61.0 - 58.0 * lat_tan2 + lat_tan4 + 600.0 * c - 330.0 * E_P2)
        )
    )
    if not northern:
        northing = northing + 10000000.0
    return easting, northing, zone_string


def latlon_from_utm(eastings, norths, zone_string: str, xp=np):
    """UTM -> geodetic (lat, lon). ref: conversions.py:130-134."""
    zone_number, zone_letter = split_zone_string(zone_string)
    northern = zone_letter >= "N"

    x = xp.asarray(eastings) - 500000.0
    y = xp.asarray(norths)
    if not northern:
        y = y - 10000000.0

    m = y / K0
    mu = m / (R * M1)

    p_rad = (
        mu
        + P2 * xp.sin(2.0 * mu)
        + P3 * xp.sin(4.0 * mu)
        + P4 * xp.sin(6.0 * mu)
        + P5 * xp.sin(8.0 * mu)
    )

    p_sin = xp.sin(p_rad)
    p_sin2 = p_sin * p_sin
    p_cos = xp.cos(p_rad)
    p_tan = p_sin / p_cos
    p_tan2 = p_tan * p_tan
    p_tan4 = p_tan2 * p_tan2

    ep_sin = 1.0 - E * p_sin2
    ep_sin_sqrt = xp.sqrt(ep_sin)

    n = R / ep_sin_sqrt
    r = (1.0 - E) / ep_sin

    c = E_P2 * p_cos**2
    c2 = c * c

    d = x / (n * K0)
    d2 = d * d
    d3 = d2 * d
    d4 = d3 * d
    d5 = d4 * d
    d6 = d5 * d

    latitude = p_rad - (p_tan / r) * (
        d2 / 2.0
        - d4 / 24.0 * (5.0 + 3.0 * p_tan2 + 10.0 * c - 4.0 * c2 - 9.0 * E_P2)
        + d6
        / 720.0
        * (61.0 + 90.0 * p_tan2 + 298.0 * c + 45.0 * p_tan4 - 252.0 * E_P2 - 3.0 * c2)
    )
    longitude = (
        d
        - d3 / 6.0 * (1.0 + 2.0 * p_tan2 + c)
        + d5
        / 120.0
        * (5.0 - 2.0 * c + 28.0 * p_tan2 - 3.0 * c2 + 8.0 * E_P2 + 24.0 * p_tan4)
    ) / p_cos
    longitude = _mod_angle(
        longitude + xp.radians(_central_longitude(zone_number)), xp
    )
    return xp.degrees(latitude), xp.degrees(longitude)


def lonlat_from_utm(eastings, norths, zone_string: str, xp=np):
    """UTM -> (lon, lat). ref: conversions.py:137-140."""
    lat, lon = latlon_from_utm(eastings, norths, zone_string, xp=xp)
    return lon, lat


def utm_from_lonlat(lons, lats, zone_string: str | None = None, xp=np):
    """(lon, lat) -> UTM. ref: conversions.py:111-115."""
    return utm_from_latlon(lats, lons, zone_string=zone_string, xp=xp)


def _mod_angle(value, xp):
    """Wrap an angle (radians) into [-pi, pi)."""
    return xp.mod(value + xp.pi, 2.0 * xp.pi) - xp.pi
