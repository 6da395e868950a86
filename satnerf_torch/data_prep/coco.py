"""Minimal pure-python COCO annotation decoding (pycocotools replacement).

The reference converts roboflow COCO exports to per-image pixel masks with
pycocotools (ref: data_prep/prepare_annotations.py:61-255, ``COCO`` +
``annToMask``); a copy of ``satnerf_tpu/data_prep/coco.py``, which needs no
pycocotools: the three
segmentation encodings COCO uses are decoded here directly:

- polygon lists ``[[x1,y1,x2,y2,...], ...]`` — scanline even-odd fill at
  pixel centers (matches pycocotools' frPyObjects rasterization up to
  boundary-pixel rounding),
- uncompressed RLE ``{"counts": [..], "size": [h, w]}`` — column-major
  run lengths alternating background/foreground, starting with background,
- compressed RLE (counts as string) — pycocotools' LEB128-style encoding
  with delta-coded runs from the third count onward.

Everything is numpy-only and import-safe everywhere.
"""

from __future__ import annotations

import json

import numpy as np


# --------------------------------------------------------------------------
# RLE
# --------------------------------------------------------------------------


def rle_counts_from_string(s: str | bytes) -> list[int]:
    """Decode pycocotools' compressed RLE count string (rleFrString)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: list[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_counts_to_string(counts: list[int]) -> str:
    """Inverse of :func:`rle_counts_from_string` (rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decode_rle(counts: list[int], h: int, w: int) -> np.ndarray:
    """Column-major run lengths -> (h, w) bool mask (rleDecode)."""
    flat = np.zeros(h * w, dtype=bool)
    pos, val = 0, False
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = not val
    assert pos == h * w, (
        f"RLE runs sum to {pos}, mask size is {h * w} — truncated or "
        "mis-sized encoding (pycocotools would decode a different mask; "
        "silent zero-filling of the tail would mislabel those pixels)"
    )
    return flat.reshape((h, w), order="F")


def encode_rle(mask: np.ndarray) -> list[int]:
    """(h, w) bool mask -> column-major run lengths (rleEncode)."""
    flat = np.asarray(mask, dtype=bool).reshape(-1, order="F")
    # run boundaries; leading zero-length background run when flat[0] is set
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return counts


# --------------------------------------------------------------------------
# polygons
# --------------------------------------------------------------------------


def rasterize_polygon(poly: list[float], h: int, w: int) -> np.ndarray:
    """Fill one flat ``[x1,y1,x2,y2,...]`` polygon: even-odd rule at pixel
    centers ``(x+0.5, y+0.5)``."""
    xs = np.asarray(poly[0::2], dtype=np.float64)
    ys = np.asarray(poly[1::2], dtype=np.float64)
    assert xs.size == ys.size and xs.size >= 3, "polygon needs >= 3 vertices"
    mask = np.zeros((h, w), dtype=bool)
    xj, yj = np.roll(xs, 1), np.roll(ys, 1)
    y0 = max(int(np.floor(ys.min() - 0.5)), 0)
    y1 = min(int(np.ceil(ys.max() + 0.5)), h)
    for y in range(y0, y1):
        yc = y + 0.5
        crossing = (ys < yc) != (yj < yc)
        if not crossing.any():
            continue
        xi, xjj = xs[crossing], xj[crossing]
        yi, yjj = ys[crossing], yj[crossing]
        nodes = np.sort(xi + (yc - yi) / (yjj - yi) * (xjj - xi))
        for k in range(0, len(nodes) - 1, 2):
            a = max(int(np.ceil(nodes[k] - 0.5)), 0)
            b = min(int(np.floor(nodes[k + 1] - 0.5)), w - 1)
            if b >= a:
                mask[y, a : b + 1] = True
    return mask


# --------------------------------------------------------------------------
# annotation -> mask, dataset index
# --------------------------------------------------------------------------


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """Decode one annotation's segmentation to an (h, w) bool mask
    (pycocotools ``annToMask`` equivalent; multiple polygons are OR-merged)."""
    seg = ann["segmentation"]
    if isinstance(seg, dict):  # RLE (crowd or roboflow bitmask export)
        sh, sw = seg["size"]
        counts = seg["counts"]
        if isinstance(counts, (str, bytes)):
            counts = rle_counts_from_string(counts)
        m = decode_rle(list(counts), int(sh), int(sw))
        assert (sh, sw) == (h, w), (
            f"RLE size {(sh, sw)} != image size {(h, w)}"
        )
        return m
    mask = np.zeros((h, w), dtype=bool)
    for poly in seg:
        mask |= rasterize_polygon(poly, h, w)
    return mask


class CocoIndex:
    """Tiny read-only index over a COCO annotation JSON."""

    def __init__(self, fp: str):
        with open(fp) as f:
            d = json.load(f)
        self.imgs = {img["id"]: img for img in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.anns_by_img: dict[int, list[dict]] = {i: [] for i in self.imgs}
        for ann in d.get("annotations", []):
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)

    def category_name(self, cat_id: int) -> str:
        return self.cats[cat_id]["name"]

    def image_anns(self, img_id: int) -> list[dict]:
        return self.anns_by_img.get(img_id, [])
