"""Scene-local coordinate systems (ECEF or UTM local frames).

ref: framework/components/coordinate_systems.py:5-43 — the scene is expressed
either in geocentric ECEF metres or in UTM easting/northing/alt metres; the
choice is the ``use_utm_coordinate_system`` pipeline flag.
"""

from __future__ import annotations

import abc

import numpy as np

from satnerf_torch.geo import ellipsoid, utm


class BaseCoordinateSystem(abc.ABC):
    """lat/lon/alt <-> scene xyz."""

    @abc.abstractmethod
    def from_latlon(self, lat, lon, alts):
        ...

    @abc.abstractmethod
    def to_lat_lon(self, x, y, z):
        ...


class CoordinateSystemECEF(BaseCoordinateSystem):
    """WGS84 geocentric frame. ref: coordinate_systems.py:19-24."""

    def from_latlon(self, lat, lon, alts):
        return ellipsoid.latlon_to_ecef(lat, lon, alts)

    def to_lat_lon(self, x, y, z):
        return ellipsoid.ecef_to_latlon(x, y, z)


class CoordinateSystemUTM(BaseCoordinateSystem):
    """UTM easting/northing/alt frame for a fixed zone.

    ref: coordinate_systems.py:27-43.
    """

    def __init__(self, zone_string: str) -> None:
        self.zone_string = zone_string

    def from_latlon(self, lat, lon, alts):
        eastings, northings, _ = utm.utm_from_latlon(
            lat, lon, zone_string=self.zone_string
        )
        return eastings, northings, np.asarray(alts)

    def to_lat_lon(self, eastings, northings, alts):
        lat, lon = utm.latlon_from_utm(eastings, northings, self.zone_string)
        return lat, lon, np.asarray(alts)


def make_coordinate_system(
    use_utm: bool, zone_string: str | None = None
) -> BaseCoordinateSystem:
    """Factory mirroring the dataset's _init_coordinate_system.

    ref: baseline/dataset/satnerf_dataset.py:152-155.
    """
    if use_utm:
        assert zone_string, "UTM coordinate system requires a zone_string"
        return CoordinateSystemUTM(zone_string)
    return CoordinateSystemECEF()
