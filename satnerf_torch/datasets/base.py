"""Base dataset: root.json manifest, splits, per-image meta loading.

ref: framework/datasets.py:17-211. Items are dicts of numpy arrays; the
training loop moves one combined ray store to device once, so datasets stay
host-side and framework-free (no torch DataLoader analogue is needed — batch
selection happens on device, see train/data.py).
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.cache import CacheDir
from satnerf_torch.core.normalization import SceneNormalization
from satnerf_torch.geo.coordinate_systems import make_coordinate_system
from satnerf_torch.io.json_io import get_file_id, read_json
from satnerf_torch.logger import logger


def predefined_val_ts(img_id: str) -> int | None:
    """Transient-embedding index for the predefined DFC2019 test images.

    Data constants from the original SatNeRF split definition
    (ref: framework/datasets.py:269-298).
    """
    aoi_id = img_id[:7]
    tables = {
        "JAX_068": {"JAX_068_013_RGB": 0, "JAX_068_002_RGB": 8, "JAX_068_012_RGB": 1},
        "JAX_004": {"JAX_004_022_RGB": 0, "JAX_004_014_RGB": 0, "JAX_004_009_RGB": 5},
        "JAX_214": {
            "JAX_214_020_RGB": 0, "JAX_214_006_RGB": 8,
            "JAX_214_001_RGB": 18, "JAX_214_008_RGB": 2,
        },
        "JAX_260": {"JAX_260_015_RGB": 0, "JAX_260_006_RGB": 3, "JAX_260_004_RGB": 10},
    }
    return tables.get(aoi_id, {}).get(img_id)


class BaseDataset:
    """Manifest + splits + coordinate system + normalization plumbing."""

    def __init__(self, cfg, dataset_name: str, split: str) -> None:
        self.cfg = cfg
        self.split = split
        self.dataset_name = f"{dataset_name}_{split}"
        self.cache = CacheDir(cfg.run.cache_dp, cfg.run.dataset_name)

        root_fp = os.path.join(cfg.run.dataset_dp, "root.json")
        self.root = read_json(root_fp)
        self.aoi_name = self.root.get("aoi_name")
        self.img_dp = os.path.join(cfg.run.dataset_dp, self.root["img_dp"])
        self.meta_dp = os.path.join(cfg.run.dataset_dp, self.root["meta_dp"])
        self.dsm_txt_fp = os.path.join(cfg.run.dataset_dp, self.root["dsm_txt_fp"])
        self.dsm_tif_fp = os.path.join(cfg.run.dataset_dp, self.root["dsm_tif_fp"])
        self.dsm_cls_fp = (
            os.path.join(cfg.run.dataset_dp, self.root["dsm_cls_fp"])
            if self.root.get("dsm_cls_fp")
            else None
        )
        self.ignore_mask_fp = (
            os.path.join(cfg.run.dataset_dp, self.root["ignore_mask_fp"])
            if self.root.get("ignore_mask_fp")
            else None
        )
        self.zone_string = self.root["zone_string"]
        self.dsm_center_lons = self.root.get("dsm_center_lons")
        self.dsm_center_lats = self.root.get("dsm_center_lats")
        self.dsm_center_alts = self.root.get("dsm_center_alts", 0.0)

        if split == "train":
            self.data_names = list(self.root["train_split"])
            limit = cfg.run.dataset_limit_train_images
            if limit:
                self.data_names = self.data_names[:limit]
        else:
            # one train image is prepended for visualization comparisons
            # (ref: datasets.py:60-64)
            self.data_names = (
                list(self.root["train_split"][:1]) + list(self.root["test_split"])
            )

        self.coordinate_system = make_coordinate_system(
            cfg.pipeline.use_utm_coordinate_system, self.zone_string
        )
        self.norm_cache_name = (
            "normalization_utm"
            if cfg.pipeline.use_utm_coordinate_system
            else "normalization"
        )
        self.normalization: SceneNormalization | None = None
        self.data: list[dict] = []
        self.combined: dict[str, np.ndarray] = {}

    # -- loading -----------------------------------------------------------
    def load(self) -> None:
        self._init_dataset_creation()
        cached = self.has_already_been_cached()
        if cached:
            logger.info("Dataset", f"{self.dataset_name}: loading rays from cache")
        for idx, name in enumerate(self.data_names):
            t_idx = idx
            if self.split != "train" and idx > 0:
                t_idx = predefined_val_ts(get_file_id(name))
                if t_idx is None:
                    t_idx = 0
            meta = read_json(os.path.join(self.meta_dp, name))
            self.data.append(
                self._create_item(name, t_idx, meta, load_from_cache=cached)
            )
        self._combine()
        logger.info(
            "Dataset",
            f"{self.dataset_name}: {len(self.data)} images, "
            f"{self.combined.get('rays', np.zeros((0,))).shape[0]} rays",
        )

    def _combine(self) -> None:
        """Concatenate all per-image tensors (ref: datasets.py:234-266)."""
        self.combined = {}
        if not self.data:
            return
        for key, value in self.data[0].items():
            if isinstance(value, np.ndarray):
                self.combined[key] = np.concatenate(
                    [item[key] for item in self.data], axis=0
                )

    # -- normalization -----------------------------------------------------
    def initialize_normalization(self, combined_rays: np.ndarray | None = None):
        """Compute or load cached normalization params.

        ref: framework/components/normalization.py:11-56 + baseline
        StandardNormalization caching.
        """
        cache_fp = os.path.join(
            self.cache.dir_path(self.norm_cache_name), "norm_params.json"
        )
        if combined_rays is not None:
            self.normalization = SceneNormalization.from_rays(combined_rays)
            self.normalization.save_json(cache_fp)
        else:
            assert os.path.isfile(cache_fp), (
                "normalization cache missing; initialize from rays first"
            )
            self.normalization = SceneNormalization.from_json(cache_fp)

    def normalize(self) -> None:
        assert self.normalization is not None
        for item in self.data:
            item["rays"] = self.normalization.normalize_rays(item["rays"])
        self._combine()

    # -- abstract ----------------------------------------------------------
    def _init_dataset_creation(self) -> None:
        pass

    def has_already_been_cached(self) -> bool:
        return False

    def _create_item(
        self, name: str, index: int, meta: dict, load_from_cache: bool
    ) -> dict:
        raise NotImplementedError

    # -- access ------------------------------------------------------------
    def __len__(self) -> int:
        if self.split == "train":
            return int(self.combined["rays"].shape[0])
        return len(self.data)

    def image_item(self, index: int) -> dict:
        """Whole-image item for validation/eval (ref: satnerf_dataset
        __getitem__ test branch)."""
        d = dict(self.data[index])
        # in the test split the first item is the prepended train view
        if self.split == "train":
            d["split"] = "train"
        else:
            d["split"] = "train" if index == 0 else "test"
        d["img_fp"] = os.path.join(self.img_dp, d["name"] + ".tif")
        return d
