"""CLS label GeoTIFF -> coloured PNG (port of
``satnerf_tpu/viz/extract_cls_viz.py``; ref: semantic/extract_cls_viz.py:9-26).
The PNG is written by ``io/png.py``, not Pillow.

CLI: python -m satnerf_torch.viz.extract_cls_viz <cls_tif> [out_png]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from satnerf_torch.data_prep.prepare_annotations import get_semantic_class_color_mapping
from satnerf_torch.io.png import save_png
from satnerf_torch.io.tiff import read_geotiff


def extract_cls_viz(cls_fp: str, out_fp: str | None = None) -> str:
    arr, _ = read_geotiff(cls_fp)
    labels = arr[0].astype(np.int64)
    colors = get_semantic_class_color_mapping()
    img = colors[np.clip(labels, 0, len(colors) - 1)]
    out_fp = out_fp or os.path.splitext(cls_fp)[0] + ".png"
    save_png(img, out_fp)
    return out_fp


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    print(extract_cls_viz(*argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
