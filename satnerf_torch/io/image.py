"""Image loading for training (ref: framework/util/img_utils.py:9-91).

* RGB GeoTIFF -> (h*w, 3) float32 in [0,1], optional bicubic downscale;
* CLS label GeoTIFF -> (h*w, 1) int32;
* save prediction images as GeoTIFF with RPC tags copied from a source image.
"""

from __future__ import annotations

import numpy as np

from satnerf_torch.io.tiff import (GeoProfile, read_geotiff,
                                  read_geotiff_profile, write_geotiff)


def load_rgb_tensor(fp: str, downscale_factor: float = 1.0) -> np.ndarray:
    """GeoTIFF RGB -> flattened (h*w, 3) float32 normalised by /255.

    ``downscale_factor`` follows the reference convention: factor 2 HALVES
    the resolution (ref: img_utils.py:23-47 resizes to size/factor; the
    matching RPC rescale is 1/factor, camera_models.py:24-36).
    """
    arr, _ = read_geotiff(fp)
    img = np.moveaxis(arr[:3].astype(np.float32), 0, -1) / 255.0  # (H, W, 3)
    if downscale_factor != 1.0:
        img = _resize_bicubic(img, 1.0 / downscale_factor)
    return img.reshape(-1, 3)


def load_cls_tensor(fp: str) -> np.ndarray:
    """Single-channel CLS GeoTIFF -> (h*w, 1) int32 labels.

    ref: img_utils.py:50-62 (load_tensor_from_cls_geotiff).
    """
    arr, _ = read_geotiff(fp)
    return arr[0].astype(np.int32).reshape(-1, 1)


def save_output_image(
    data: np.ndarray,
    out_fp: str,
    source_fp: str | None = None,
    nodata: float | None = None,
):
    """Save (C, H, W) or (H, W) prediction as GeoTIFF, copying geo/RPC tags
    from a source image when given (ref: img_utils.py:65-91)."""
    if data.ndim == 2:
        data = data[None]
    profile = GeoProfile(
        width=data.shape[2], height=data.shape[1], count=data.shape[0],
        dtype=str(data.dtype), nodata=nodata,
    )
    if source_fp is not None:
        # tag-only read: never decompress the source pixels just for tags
        src = read_geotiff_profile(source_fp)
        profile.transform = src.transform
        profile.epsg = src.epsg
        profile.rpc = src.rpc
    write_geotiff(out_fp, data, profile)


def _resize_bicubic(img: np.ndarray, factor: float) -> np.ndarray:
    """Bicubic resize via OpenCV (present in the image) with numpy fallback.

    Target size is ``floor(size * factor)`` to match the reference's
    ``int(w // downscale_factor)`` (img_utils.py:27-29): rounding instead
    gives a 1-px larger image for odd sizes, desynchronised from the RPC
    camera rescaled by 1/factor and from the rays grid built on it.
    """
    h, w = img.shape[:2]
    new_w, new_h = int(w * factor), int(h * factor)
    try:
        import cv2

        return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_CUBIC)
    except ImportError:  # pragma: no cover
        return _cubic_resize_np(img, new_h, new_w)


def _cubic_resize_np(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Separable cubic-convolution resize, pure numpy, for environments
    without OpenCV. a=-0.75 is the coefficient cv2's INTER_CUBIC and
    torch's bicubic both use (the reference resizes torch tensors, so
    this matches the reference kernel as well)."""
    def kernel(x, a=-0.75):
        ax = np.abs(x)
        w = np.where(
            ax <= 1,
            (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
            np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a,
                     0.0),
        )
        return w

    def resize_axis(arr, new_n, axis):
        n = arr.shape[axis]
        scale = n / new_n
        # pixel-center mapping, same convention as cv2.resize
        centers = (np.arange(new_n) + 0.5) * scale - 0.5
        base = np.floor(centers).astype(int)
        offs = np.arange(-1, 3)
        idx = np.clip(base[:, None] + offs[None, :], 0, n - 1)  # (new_n, 4)
        wts = kernel(centers[:, None] - (base[:, None] + offs[None, :]))
        wts /= wts.sum(axis=1, keepdims=True)
        moved = np.moveaxis(arr, axis, 0)
        out = np.einsum("ok,ok...->o...", wts, moved[idx])
        return np.moveaxis(out, 0, axis)

    out = resize_axis(img.astype(np.float64), new_h, 0)
    out = resize_axis(out, new_w, 1)
    return out.astype(img.dtype, copy=False)
