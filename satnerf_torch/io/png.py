"""PNG encoding and decoding with numpy and ``zlib`` only.

The port writes PNGs wherever the JAX package calls Pillow (the render-view
images, the HTTP ``/render`` bodies, the confusion-matrix figures, the study
tools), so it runs where Pillow is not installed. :func:`encode_png` writes
8-bit gray, RGB or RGBA with filter 0 (none) on every row; :func:`decode_png`
reads such files back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE or 0 in img.shape[:2]:
        raise ValueError(f"cannot encode an image of shape {img.shape} as PNG")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0, then the row
    rows[:, 1:] = img.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(img: np.ndarray, fp: str) -> None:
    with open(fp, "wb") as f:
        f.write(encode_png(img))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8: an 8-bit gray, RGB or RGBA
    PNG, not interlaced, with filter 0 on every row (as encode_png writes)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError("PNG rows with a filter other than 0 are not supported")
    img = raw[:, 1:].reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def load_png(fp: str) -> np.ndarray:
    with open(fp, "rb") as f:
        return decode_png(f.read())
