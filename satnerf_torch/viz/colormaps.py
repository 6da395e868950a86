"""Colormaps in numpy (port of ``apply_colormap`` in
``satnerf_tpu/viz/colormaps.py``, which calls OpenCV).

The tables are OpenCV's 256-entry ``COLORMAP_BONE``, ``COLORMAP_JET`` and
``COLORMAP_VIRIDIS`` as RGB uint8, stored as zlib-compressed first
differences (mod 256) in base64, so the port needs neither OpenCV nor
matplotlib and gives the reference's pixels exactly.
"""

from __future__ import annotations

import base64
import zlib

import numpy as np

_TABLES = {
    "bone": "eNrFUUEOwCAIq/3/o3WMRYFu2cVIwqG2KRUANC+OnsjgXfY44Sd1wcUks4DwefTZZ3eeGKbmWc"
            "SvWUxPSBujxAQ0yN0MKJO6Pv8Y3kfzsCyaUc5yFcar/NRv8u9v3QL+",
    "jet": "eNpjYGhgYGChJWKmrfE0RkzM/1kY/gxZ9Jvx73+GPwxDF/2lsQ0Ao1KhgQ==",
    "viridis": "eNp1kIENAzEIA01+tY7Q/Uf5FIxDaJtXK+s4nLyUl71hw3+ViDQbwxPKmNNvKU5o2yVnAEr2sT"
               "jACBqzgCxMca3gNyd0+cXjuP3JuvZc2CMOnaezG/BUmP83SKLkRFt1aX2LND1jqxddXs+Q"
               "7y3YnA8sXklJqD+O4935Eoe8CkKmyfH2TqT32Vmpzi4E56mbftKwyUIclJk6K8ivgwVcAU"
               "bwNLKRB8FzfAARMYgK",
}


def _decode_table(cmap: str) -> np.ndarray:
    """(256, 3) uint8 RGB table of ``cmap`` ("bone", "jet", "viridis")."""
    diff = np.frombuffer(zlib.decompress(base64.b64decode(_TABLES[cmap])), np.uint8)
    return np.cumsum(diff.reshape(256, 3), axis=0, dtype=np.uint64).astype(np.uint8)


_LUTS = {name: _decode_table(name) for name in _TABLES}


def apply_colormap(img: np.ndarray, cmap: str = "bone") -> np.ndarray:
    """Min-max normalise a (H, W) map and apply a colormap -> (H, W, 3) f32
    in [0, 1]; an unknown name gives bone, as the reference does."""
    img = np.asarray(img, dtype=np.float64)
    finite = np.isfinite(img)
    lo = img[finite].min() if finite.any() else 0.0
    hi = img[finite].max() if finite.any() else 1.0
    norm = np.nan_to_num((img - lo) / max(hi - lo, 1e-12), nan=0.0)
    u8 = (np.clip(norm, 0, 1) * 255).astype(np.uint8)
    return _LUTS.get(cmap, _LUTS["bone"])[u8].astype(np.float32) / 255.0
