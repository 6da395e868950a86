"""Annotation tooling: class map, colors, mask conversion, label corruption
(a copy of ``satnerf_tpu/data_prep/prepare_annotations.py``).

ref: data_prep/prepare_annotations.py:16-481 — the five-class label scheme
(ground/water/vegetation/buildings/cars), the class color map used across the
visualizers (the cross-layer import the reference makes from
semantic/components/visualize.py:16-18 is preserved: viz imports colors from
here), COCO-annotation to pixel-mask conversion (pure-python polygon/RLE
decoding via satnerf_torch.data_prep.coco — no pycocotools), and the
label-corruption generator for the robustness experiments.

CLI: python -m satnerf_torch.data_prep.prepare_annotations corrupt <cls_dp> <out_dp>
"""

from __future__ import annotations

import os
import sys

import numpy as np

LABELS = {"ground": 0, "water": 1, "vegetation": 2, "buildings": 3, "cars": 4}

# class color map (uint8 RGB rows per class id + one spare row)
SEMANTIC_CLASS_COLOR_MAPPING = np.array(
    [
        [229, 232, 157],  # ground: light yellow
        [35, 161, 228],   # water: light blue
        [9, 171, 120],    # vegetation: green
        [138, 138, 138],  # buildings: light gray
        [193, 79, 69],    # cars: red
        [98, 98, 98],     # spare: dark gray
    ],
    dtype=np.uint8,
)

# corruption settings (ref: prepare_annotations.py:37-60)
CORRUPT_BORDER_GROWTH = {
    "ground": 10, "water": 0, "vegetation": 10, "buildings": 10, "cars": 0,
}
CORRUPT_CLASS_PROBABILITY = {
    "ground": 0.10, "water": 0.05, "vegetation": 0.15, "buildings": 0.10,
    "cars": 0.0,
}
CORRUPT_REPLACE_WITH = ["ground", "vegetation", "buildings"]


def get_semantic_class_color_mapping() -> np.ndarray:
    return SEMANTIC_CLASS_COLOR_MAPPING


# --------------------------------------------------------------------------
# label corruption generator (ref: prepare_annotations.py:257-326)
# --------------------------------------------------------------------------


def corrupt_labels(mask: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deliberate label noise for robustness experiments.

    Per class: threshold blurred noise to select blob-shaped regions and
    relabel them to a random replacement class; additionally grow noisy
    borders around class boundaries. Produces the ``own_corrupted`` label
    variant consumed via ``semantic_dataset_type="own_corrupted"``.
    """
    rng = np.random.default_rng(seed)
    h, w = mask.shape
    out = mask.copy()
    replace_ids = [LABELS[name] for name in CORRUPT_REPLACE_WITH]

    for name, prob in CORRUPT_CLASS_PROBABILITY.items():
        if prob <= 0:
            continue
        cls_id = LABELS[name]
        region = mask == cls_id
        if not region.any():
            continue
        # blob noise: blurred uniform field thresholded at the class prob
        noise = rng.uniform(size=(h, w))
        noise = _box_blur(noise, 7)
        lo, hi = noise.min(), noise.max()
        blobs = (noise - lo) / max(hi - lo, 1e-9) < prob
        flip = region & blobs
        new_label = replace_ids[int(rng.integers(len(replace_ids)))]
        out[flip] = new_label

    # border dilation noise: jitter class boundaries
    for name, growth in CORRUPT_BORDER_GROWTH.items():
        if growth <= 0:
            continue
        cls_id = LABELS[name]
        region = out == cls_id
        border = _binary_dilate(region, growth) & ~region
        jitter = rng.uniform(size=(h, w)) < 0.35
        out[border & jitter] = cls_id
    return out


def make_no_cars(mask: np.ndarray, default_class: str = "ground") -> np.ndarray:
    """ref: prepare_annotations.py no-cars variant (cars -> default class)."""
    out = mask.copy()
    out[out == LABELS["cars"]] = LABELS[default_class]
    return out


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    pad = k // 2
    padded = np.pad(img, pad, mode="edge")
    out = np.zeros_like(img)
    for dy in range(k):
        for dx in range(k):
            out += padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return out / (k * k)


def _binary_dilate(mask: np.ndarray, it: int = 1) -> np.ndarray:
    out = mask.copy()
    for _ in range(it):
        grown = out.copy()
        grown[1:, :] |= out[:-1, :]
        grown[:-1, :] |= out[1:, :]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


# --------------------------------------------------------------------------
# COCO mask conversion (ref: prepare_annotations.py:61-255)
# --------------------------------------------------------------------------


def coco_mask_for_image(
    coco, img_id: int, h: int, w: int,
    default_class: str = "ground", no_cars: bool = False,
) -> np.ndarray:
    """Pixel mask for one COCO image (ref get_mask_for_img semantics,
    prepare_annotations.py:218-255): unlabeled pixels take the scene's
    default class, overlaps resolve to the highest-ranked class (cars over
    buildings over vegetation over ...), ``no_cars`` drops car annotations."""
    mask = np.full((h, w), -1, dtype=np.int16)
    from satnerf_torch.data_prep.coco import ann_to_mask

    for ann in coco.image_anns(img_id):
        rank = LABELS.get(coco.category_name(ann["category_id"]), 0)
        if no_cars and rank == LABELS["cars"]:
            continue
        m = ann_to_mask(ann, h, w)
        np.maximum(mask, np.where(m, rank, -1), out=mask)
    mask[mask < 0] = LABELS.get(default_class, 0)
    return mask.astype(np.uint8)


def coco_to_masks(
    coco_json_fp: str, out_dp: str,
    height: int | None = None, width: int | None = None,
    default_class: str = "ground", no_cars: bool = False,
):
    """Convert roboflow-style COCO annotations to per-image pixel masks
    (.npy per image, uint8 class ids).

    Pure-python polygon + RLE decoding (satnerf_torch.data_prep.coco) — no
    pycocotools needed. ``height``/``width`` override the per-image sizes
    recorded in the JSON (normally omitted).
    """
    from satnerf_torch.data_prep.coco import CocoIndex

    coco = CocoIndex(coco_json_fp)
    os.makedirs(out_dp, exist_ok=True)
    for img_id, info in coco.imgs.items():
        h = height if height is not None else int(info["height"])
        w = width if width is not None else int(info["width"])
        mask = coco_mask_for_image(
            coco, img_id, h, w, default_class=default_class, no_cars=no_cars
        )
        out_fp = os.path.join(
            out_dp, os.path.splitext(info["file_name"])[0] + ".npy"
        )
        # roboflow/COCO exports may namespace file_name with a subdirectory
        os.makedirs(os.path.dirname(out_fp), exist_ok=True)
        np.save(out_fp, mask)


def _cli_corrupt(cls_dp: str, out_dp: str, seed: int | str = 0):
    from satnerf_torch.io.tiff import read_geotiff, write_geotiff

    seed = int(seed)  # argv passes strings; default_rng('5') is a TypeError
    os.makedirs(out_dp, exist_ok=True)
    for img_i, name in enumerate(sorted(os.listdir(cls_dp))):
        if not name.endswith(".tif"):
            continue
        arr, profile = read_geotiff(os.path.join(cls_dp, name))
        # per-image seed, same rationale as steps/step_semantic.py
        corrupted = corrupt_labels(arr[0].astype(np.uint8), seed=seed + img_i)
        write_geotiff(os.path.join(out_dp, name), corrupted[None], profile)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd, *args = argv
    {"corrupt": _cli_corrupt}[cmd](*args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
