"""Geodesy foundation: WGS84 ellipsoid, UTM projection, RPC camera models.

Self-contained (no rpcm/utm/pymap3d dependency); numpy float64 on the host,
used for dataset construction and DSM back-projection.
"""

from satnerf_torch.geo.ellipsoid import (  # noqa: F401
    ecef_to_latlon,
    latlon_to_ecef,
)
from satnerf_torch.geo.utm import (  # noqa: F401
    latlon_from_utm,
    latlon_to_zone_string,
    lonlat_from_utm,
    split_zone_string,
    utm_from_latlon,
    utm_from_lonlat,
    zonestring_to_hemisphere,
)
from satnerf_torch.geo.rpc import RPCModel, rescale_rpc  # noqa: F401
from satnerf_torch.geo.coordinate_systems import (  # noqa: F401
    BaseCoordinateSystem,
    CoordinateSystemECEF,
    CoordinateSystemUTM,
    make_coordinate_system,
)
