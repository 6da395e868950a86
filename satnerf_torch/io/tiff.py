"""Self-contained GeoTIFF reader/writer.

The runtime image format of the framework (rasterio/GDAL are not available in
the runtime images). Supports the subset the satellite pipelines need
(ref usage: framework/util/img_utils.py:9-91, eval/utils/dsm.py:85-101):

* classic little-endian TIFF, striped storage, planar config 1;
* dtypes uint8/uint16/int16/float32/float64, 1..4 samples per pixel;
* compression: none (1) or zlib/deflate (8);
* GeoTIFF georeferencing via ModelTiepoint+ModelPixelScale and an EPSG code in
  the GeoKeyDirectory (enough for north-up UTM DSM rasters);
* the 92-double RPC coefficient tag (50844) so adjusted RPCs ride inside the
  image files exactly as GDAL writes them;
* the GDAL_NODATA ascii tag (42113).

Reading files produced by GDAL works for striped AND tiled layouts with
any of the supported compressions (DFC2019 distribution tifs are striped;
tiled support covers GDAL's ``-co TILED=YES`` outputs).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from satnerf_torch.geo.rpc import RPCModel

# tag ids
T_WIDTH = 256
T_HEIGHT = 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES = 277
T_ROWS_PER_STRIP = 278
T_STRIP_COUNTS = 279
T_PLANAR = 284
T_PREDICTOR = 317
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_COUNTS = 325
T_SAMPLE_FORMAT = 339
T_PIXEL_SCALE = 33550
T_TIEPOINT = 33922
T_GEO_KEYS = 34735
T_GEO_DOUBLES = 34736
T_GEO_ASCII = 34737
T_GDAL_NODATA = 42113
T_RPC = 50844

# field types
FT_BYTE, FT_ASCII, FT_SHORT, FT_LONG, FT_RATIONAL = 1, 2, 3, 4, 5
FT_SBYTE, FT_UNDEF, FT_SSHORT, FT_SLONG = 6, 7, 8, 9
FT_FLOAT, FT_DOUBLE = 11, 12
_FT_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 11: 4, 12: 8}
_FT_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d"}


@dataclass
class GeoProfile:
    """Raster metadata bundle (the rasterio 'profile' analogue)."""

    width: int
    height: int
    count: int = 1
    dtype: str = "float32"
    # north-up affine: x = xoff + col*sx ; y = yoff - row*sy
    transform: Optional[tuple] = None  # (sx, sy, xoff, yoff)
    epsg: Optional[int] = None
    nodata: Optional[float] = None
    rpc: Optional[RPCModel] = None

    def pixel_to_xy(self, col, row):
        sx, sy, xoff, yoff = self.transform
        return xoff + np.asarray(col) * sx, yoff - np.asarray(row) * sy

    def xy_to_pixel(self, x, y):
        sx, sy, xoff, yoff = self.transform
        return (np.asarray(x) - xoff) / sx, (yoff - np.asarray(y)) / sy


def epsg_for_utm(zone_string: str) -> int:
    """MGRS zone string ('17R') -> EPSG (32617; southern bands -> 327xx).

    The trailing letter is interpreted as an MGRS LATITUDE BAND (C-X,
    where N..X are northern and C..M southern — so '17S' is NORTHERN).
    Do NOT pass hemisphere-style strings (the '17N'/'17S' output of
    ``geo.zonestring_to_hemisphere``): 'S' means the opposite thing in
    that convention and the DSM would be georeferenced ~10,000 km off.
    """
    zone = int(zone_string[:-1])
    band = zone_string[-1].upper()
    assert "C" <= band <= "X" and band not in ("I", "O"), (
        f"{zone_string!r}: {band!r} is not an MGRS latitude band"
    )
    northern = band >= "N"
    return (32600 if northern else 32700) + zone


_NP_DTYPES = {
    ("uint8"): (8, 1),
    ("uint16"): (16, 1),
    ("int16"): (16, 2),
    ("int32"): (32, 2),
    ("float32"): (32, 3),
    ("float64"): (64, 3),
}


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------


def write_geotiff(fp: str, array: np.ndarray, profile: GeoProfile, compress: bool = True):
    """Write (count, H, W) or (H, W) array as a striped GeoTIFF."""
    if array.ndim == 2:
        array = array[None]
    count, h, w = array.shape
    assert count == profile.count and h == profile.height and w == profile.width, (
        f"array shape {array.shape} does not match profile "
        f"({profile.count},{profile.height},{profile.width})"
    )
    array = np.ascontiguousarray(
        np.moveaxis(array, 0, -1), dtype=np.dtype(profile.dtype)
    )  # interleaved (H, W, C)

    bits, sample_format = _NP_DTYPES[profile.dtype]

    raw = array.tobytes()
    data = zlib.compress(raw, 6) if compress else raw

    entries: list[tuple[int, int, int, bytes]] = []  # (tag, type, n, payload)

    def tag(tid, ftype, values):
        if isinstance(values, (bytes, bytearray)):
            payload = bytes(values)
            n = len(payload)
        else:
            if np.isscalar(values):
                values = [values]
            payload = struct.pack(
                "<" + _FT_FMT[ftype] * len(values), *values
            )
            n = len(values)
        entries.append((tid, ftype, n, payload))

    tag(T_WIDTH, FT_LONG, w)
    tag(T_HEIGHT, FT_LONG, h)
    tag(T_BITS, FT_SHORT, [bits] * count)
    tag(T_COMPRESSION, FT_SHORT, 8 if compress else 1)
    tag(T_PHOTOMETRIC, FT_SHORT, 2 if count >= 3 else 1)
    tag(T_SAMPLES, FT_SHORT, count)
    tag(T_ROWS_PER_STRIP, FT_LONG, h)
    tag(T_PLANAR, FT_SHORT, 1)
    tag(T_SAMPLE_FORMAT, FT_SHORT, [sample_format] * count)

    if profile.transform is not None:
        sx, sy, xoff, yoff = profile.transform
        tag(T_PIXEL_SCALE, FT_DOUBLE, [sx, sy, 0.0])
        tag(T_TIEPOINT, FT_DOUBLE, [0.0, 0.0, 0.0, xoff, yoff, 0.0])
    if profile.epsg is not None:
        # minimal GeoKeyDirectory: version 1.1.0, 3 keys
        keys = [
            1, 1, 0, 3,
            1024, 0, 1, 1,      # GTModelTypeGeoKey = projected
            1025, 0, 1, 1,      # GTRasterTypeGeoKey = pixel-is-area
            3072, 0, 1, profile.epsg,  # ProjectedCSTypeGeoKey
        ]
        tag(T_GEO_KEYS, FT_SHORT, keys)
    if profile.nodata is not None:
        tag(T_GDAL_NODATA, FT_ASCII, (repr(float(profile.nodata)) + "\0").encode())
    if profile.rpc is not None:
        tag(T_RPC, FT_DOUBLE, list(profile.rpc.to_geotiff_tag()))

    # layout: header | IFD (incl. strip tags) | external tag payloads | strip
    ifd_offset = 8
    n_entries = len(entries) + 2  # + strip offsets/counts
    ifd_size = 2 + n_entries * 12 + 4

    ext_offset_cursor = ifd_offset + ifd_size
    ext_blobs: list[bytes] = []

    def alloc(payload: bytes) -> int:
        nonlocal ext_offset_cursor
        off = ext_offset_cursor
        pad = payload + (b"\0" if len(payload) % 2 else b"")
        ext_blobs.append(pad)
        ext_offset_cursor += len(pad)
        return off

    packed = []
    for tid, ftype, n, payload in entries:
        if len(payload) <= 4:
            packed.append((tid, ftype, n, payload.ljust(4, b"\0")))
        else:
            packed.append((tid, ftype, n, struct.pack("<I", alloc(payload))))
    strip_offset = ext_offset_cursor
    packed.append((T_STRIP_OFFSETS, FT_LONG, 1, struct.pack("<I", strip_offset)))
    packed.append((T_STRIP_COUNTS, FT_LONG, 1, struct.pack("<I", len(data))))
    packed.sort(key=lambda e: e[0])  # TIFF requires ascending tag order

    out = bytearray()
    out += b"II*\0" + struct.pack("<I", ifd_offset)
    out += struct.pack("<H", len(packed))
    for tid, ftype, n, value4 in packed:
        out += struct.pack("<HHI", tid, ftype, n) + value4
    out += struct.pack("<I", 0)  # next IFD
    for blob in ext_blobs:
        out += blob
    out += data

    os.makedirs(os.path.dirname(fp) or ".", exist_ok=True)
    with open(fp, "wb") as f:
        f.write(bytes(out))


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------


def _parse_ifd_tags(fp: str, fetch) -> tuple[str, dict[int, list]]:
    """Parse the first IFD via ``fetch(offset, size) -> bytes``.

    The fetch indirection lets ``read_geotiff`` parse an in-memory buffer
    while ``read_geotiff_profile`` seeks inside the open file and never
    touches strip/tile pixel data.
    """
    head = fetch(0, 8)
    if head[:2] == b"II":
        bo = "<"
    elif head[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{fp}: not a TIFF file")
    magic, ifd_off = struct.unpack(bo + "HI", head[2:8])
    assert magic == 42, f"{fp}: bad TIFF magic {magic}"

    tags: dict[int, list] = {}
    (n_entries,) = struct.unpack(bo + "H", fetch(ifd_off, 2))
    entries = fetch(ifd_off + 2, n_entries * 12)
    for i in range(n_entries):
        e = entries[i * 12 : (i + 1) * 12]
        tid, ftype, n = struct.unpack(bo + "HHI", e[:8])
        size = _FT_SIZE.get(ftype, 1) * n
        if size <= 4:
            payload = e[8 : 8 + size]
        else:
            (off,) = struct.unpack(bo + "I", e[8:12])
            payload = fetch(off, size)
        if ftype == FT_ASCII:
            tags[tid] = [payload.rstrip(b"\0").decode("latin1")]
        elif ftype in _FT_FMT:
            tags[tid] = list(struct.unpack(bo + _FT_FMT[ftype] * n, payload))
        elif ftype == FT_RATIONAL:
            vals = struct.unpack(bo + "I" * (2 * n), payload)
            tags[tid] = [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(n)]
    return bo, tags


_DTYPES = {
    (8, 1): np.uint8, (16, 1): np.uint16, (32, 1): np.uint32,
    (8, 2): np.int8, (16, 2): np.int16, (32, 2): np.int32,
    (32, 3): np.float32, (64, 3): np.float64,
}


def read_geotiff_profile(fp: str) -> GeoProfile:
    """Tag-only read: geo/RPC/shape metadata WITHOUT decoding pixel data.

    Used to copy tags from a (possibly large, compressed) source raster —
    ``read_geotiff`` would decompress every strip/tile just to reach the
    profile. Seeks inside the file; never reads the pixel payload.
    """
    with open(fp, "rb") as f:

        def fetch(off, size):
            f.seek(off)
            return f.read(size)

        _, tags = _parse_ifd_tags(fp, fetch)
    return _profile_from_tags(tags)


def read_geotiff(fp: str) -> tuple[np.ndarray, GeoProfile]:
    """Read a striped (Geo)TIFF -> ((count, H, W) array, GeoProfile)."""
    with open(fp, "rb") as f:
        buf = f.read()

    bo, tags = _parse_ifd_tags(fp, lambda off, size: buf[off : off + size])

    w = int(tags[T_WIDTH][0])
    h = int(tags[T_HEIGHT][0])
    count = int(tags.get(T_SAMPLES, [1])[0])
    bits = int(tags.get(T_BITS, [8])[0])
    compression = int(tags.get(T_COMPRESSION, [1])[0])
    sample_format = int(tags.get(T_SAMPLE_FORMAT, [1])[0])
    planar = int(tags.get(T_PLANAR, [1])[0])
    predictor = int(tags.get(T_PREDICTOR, [1])[0])
    assert planar == 1, f"{fp}: planar config {planar} unsupported"
    if predictor not in (1, 2, 3):
        # never decode silently with an unapplied predictor — the caller
        # would get numerically corrupt pixels with no error
        raise NotImplementedError(f"{fp}: TIFF predictor {predictor}")

    dtype = _DTYPES[(bits, sample_format)]

    def _decode(off, cnt, expected=0):
        raw = buf[int(off) : int(off) + int(cnt)]
        if compression == 8 or compression == 32946:
            raw = zlib.decompress(raw)
        elif compression == 5:
            raw = _lzw_decode(raw, expected)
        elif compression != 1:
            raise NotImplementedError(f"{fp}: compression {compression}")
        return raw

    np_dt = np.dtype(dtype).newbyteorder(bo)

    if T_TILE_WIDTH in tags:
        # tiled layout: row-major grid of (tl x tw) interleaved tiles,
        # edge tiles padded to the full tile size
        tw = int(tags[T_TILE_WIDTH][0])
        tl = int(tags[T_TILE_LENGTH][0])
        tiles_x = (w + tw - 1) // tw
        tiles_y = (h + tl - 1) // tl
        offsets = tags[T_TILE_OFFSETS]
        counts = tags[T_TILE_COUNTS]
        assert len(offsets) == tiles_x * tiles_y, (
            f"{fp}: {len(offsets)} tiles for a {tiles_y}x{tiles_x} grid"
        )
        arr = np.zeros((h, w, count), dtype)
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                raw = _decode(
                    offsets[ty * tiles_x + tx], counts[ty * tiles_x + tx],
                    expected=tl * tw * count * (bits // 8),
                )
                if predictor == 3:  # float byte-shuffle differencing
                    tile = _undo_predictor3(
                        raw, tl, tw * count, bits // 8, dtype
                    ).reshape(tl, tw, count)
                else:
                    tile = np.frombuffer(raw, dtype=np_dt)[: tl * tw * count]
                    assert tile.size == tl * tw * count, (
                        f"{fp}: tile ({ty},{tx}) decoded to {tile.size} "
                        f"samples, expected {tl * tw * count} "
                        "(truncated or corrupt tile)"
                    )
                    tile = tile.reshape(tl, tw, count)
                    if predictor == 2:  # per-tile horizontal differencing
                        tile = np.cumsum(
                            tile.astype(np.int64), axis=1
                        ).astype(dtype)
                ys, xs = ty * tl, tx * tw
                ny, nx = min(tl, h - ys), min(tw, w - xs)
                arr[ys : ys + ny, xs : xs + nx] = tile[:ny, :nx]
    else:
        offsets = tags[T_STRIP_OFFSETS]
        counts = tags[T_STRIP_COUNTS]
        # clamp: TIFF 6.0 allows RowsPerStrip = 2^32-1 ("one strip") — the
        # image height bounds the real decoded size either way
        rows_per_strip = min(int(tags.get(T_ROWS_PER_STRIP, [h])[0]), h)
        strip_bytes = rows_per_strip * w * count * (bits // 8)
        data = b"".join(
            _decode(o, c, expected=strip_bytes)
            for o, c in zip(offsets, counts)
        )
        if predictor == 3:  # rows are independent, so strip joins are safe
            arr = _undo_predictor3(
                data, h, w * count, bits // 8, dtype
            ).reshape(h, w, count)
        else:
            arr = np.frombuffer(data, dtype=np_dt)
            arr = arr[: h * w * count].reshape(h, w, count)
            if predictor == 2:  # horizontal differencing, full-row strips
                arr = np.cumsum(arr.astype(np.int64), axis=1).astype(dtype)
    arr = np.moveaxis(arr, -1, 0).copy()
    return arr, _profile_from_tags(tags)


def _profile_from_tags(tags: dict[int, list]) -> GeoProfile:
    """Geo/RPC/shape metadata from a parsed IFD tag dict."""
    w = int(tags[T_WIDTH][0])
    h = int(tags[T_HEIGHT][0])
    count = int(tags.get(T_SAMPLES, [1])[0])
    bits = int(tags.get(T_BITS, [8])[0])
    sample_format = int(tags.get(T_SAMPLE_FORMAT, [1])[0])
    dtype = _DTYPES[(bits, sample_format)]

    transform = None
    if T_PIXEL_SCALE in tags and T_TIEPOINT in tags:
        sx, sy = tags[T_PIXEL_SCALE][0], tags[T_PIXEL_SCALE][1]
        tp = tags[T_TIEPOINT]
        # tiepoint (i, j, k, x, y, z) with (i,j) usually (0,0)
        xoff = tp[3] - tp[0] * sx
        yoff = tp[4] + tp[1] * sy
        transform = (sx, sy, xoff, yoff)

    epsg = None
    if T_GEO_KEYS in tags:
        keys = tags[T_GEO_KEYS]
        for i in range(4, len(keys), 4):
            if keys[i] == 3072:
                epsg = int(keys[i + 3])

    nodata = None
    if T_GDAL_NODATA in tags:
        try:
            nodata = float(tags[T_GDAL_NODATA][0].strip().split("\0")[0])
        except ValueError:
            pass

    rpc = None
    if T_RPC in tags and len(tags[T_RPC]) == 92:
        rpc = RPCModel.from_geotiff_tag(tags[T_RPC])

    return GeoProfile(
        width=w, height=h, count=count, dtype=np.dtype(dtype).name,
        transform=transform, epsg=epsg, nodata=nodata, rpc=rpc,
    )


def _undo_predictor3(raw: bytes, rows: int, row_values: int, itemsize: int,
                     dtype) -> np.ndarray:
    """Undo TIFF predictor 3 (floating-point horizontal differencing,
    TIFF Technical Note 3): per row, value bytes are stored split into
    byte planes (MSB plane first, independent of the file's byte order)
    and the plane-ordered byte stream is delta-encoded. Returns a
    (rows, row_values) array in the native dtype."""
    row_bytes = row_values * itemsize
    b = np.frombuffer(raw, np.uint8)
    assert b.size >= rows * row_bytes, (
        f"predictor-3 payload has {b.size} bytes, "
        f"expected {rows * row_bytes} (truncated or corrupt)"
    )
    b = b[: rows * row_bytes].reshape(rows, row_bytes)
    b = np.cumsum(b, axis=1, dtype=np.uint32).astype(np.uint8)  # mod-256
    planes = b.reshape(rows, itemsize, row_values)
    interleaved = np.ascontiguousarray(np.moveaxis(planes, 1, 2))
    vals = np.frombuffer(
        interleaved.tobytes(), dtype=np.dtype(dtype).newbyteorder(">")
    )
    return vals.reshape(rows, row_values).astype(dtype)


def _lzw_decode(data: bytes, expected: int = 0) -> bytes:
    """TIFF LZW (MSB-first, early-change) decoder for reading GDAL files.

    Hot path runs in C++ (native/src/satnerf_native.cpp:sn_lzw_decode,
    ~100x the per-byte Python loop below, which remains the fallback for
    environments without the toolchain). ``expected`` is the decompressed
    size when the caller knows it (tile/strip geometry); used to size the
    native output buffer exactly.
    """
    from satnerf_torch.ops import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "sn_lzw_decode"):
        cap = expected if expected > 0 else max(4 * len(data), 1 << 16)
        src = np.frombuffer(data, dtype=np.uint8)
        while True:
            out = np.empty(cap, dtype=np.uint8)
            n = lib.sn_lzw_decode(
                native.as_u8_ptr(src), len(data), native.as_u8_ptr(out), cap
            )
            if n >= 0:
                return out[:n].tobytes()
            if n == -1:  # capacity too small (padded edge strips, etc.)
                cap *= 2
                continue
            break  # -2 corrupt stream: fall through to the python decoder
    return _lzw_decode_py(data)


def _lzw_decode_py(data: bytes) -> bytes:
    CLEAR, EOI = 256, 257
    result = bytearray()
    table: list[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bits, acc, nbits = 9, 0, 0
    prev = None
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= bits:
            code = (acc >> (nbits - bits)) & ((1 << bits) - 1)
            nbits -= bits
            if code == CLEAR:
                reset()
                bits = 9
                prev = None
                continue
            if code == EOI:
                return bytes(result)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            result += entry
            prev = entry
            if len(table) >= (1 << bits) - 1 and bits < 12:
                bits += 1
    return bytes(result)
