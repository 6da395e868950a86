"""Colormaps and the TensorBoard downscale in numpy (port of
``satnerf_tpu/viz/colormaps.py``, which calls OpenCV).

The tables are OpenCV's 256-entry ``COLORMAP_BONE``, ``COLORMAP_JET`` and
``COLORMAP_VIRIDIS`` as RGB uint8, stored as zlib-compressed first
differences (mod 256) in base64, so the port needs neither OpenCV nor
matplotlib and gives the reference's pixels exactly.

``scale_for_tensorboard`` is OpenCV's ``INTER_AREA`` downscale: each output
pixel is the mean of the source area it covers, with the fractional weights
of ``computeResizeAreaTab`` at a non-integer factor, applied as one
(out, in) weight matrix per axis.
"""

from __future__ import annotations

import base64
import math
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


def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) f32 weights of OpenCV's area resize along one axis
    (``computeResizeAreaTab``, downscale only)."""
    scale = 1.0 / (n_dst / n_src)  # OpenCV's 1 / inv_scale
    w = np.zeros((n_dst, n_src), np.float32)
    for dx in range(n_dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_src - fsx1)
        sx2 = min(math.floor(fsx2), n_src - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        w[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def scale_for_tensorboard(img_chw: np.ndarray, size: int = 400) -> np.ndarray:
    """Downscale a (C, H, W) image so max(H, W) <= size, by area
    (ref: other.py scale_image_for_tensorboard). A uint8 image stays uint8
    (tensorboardX multiplies any other dtype by 255)."""
    c, h, w = img_chw.shape
    m = max(h, w)
    if m <= size:
        return img_chw
    f = size / m
    wy = _area_weights(h, int(h * f))
    wx = _area_weights(w, int(w * f))
    out = wy @ img_chw.astype(np.float32) @ wx.T
    if img_chw.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    return out
