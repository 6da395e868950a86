"""IO: self-contained GeoTIFF read/write (rasterio replacement), image
loading, root.json manifests, JSON helpers, PNG (``io/png.py``)."""

from satnerf_torch.io.tiff import GeoProfile, read_geotiff, write_geotiff  # noqa: F401
from satnerf_torch.io.image import (  # noqa: F401
    load_rgb_tensor,
    load_cls_tensor,
    save_output_image,
)
from satnerf_torch.io.json_io import read_json, write_json  # noqa: F401
