"""Semantic dataset: RGB rays + per-pixel CLS labels + sparsity masks.

ref: semantic/dataset/semantic_dataset.py:8-90 — label CLS GeoTIFFs come from
``semantic_dp_{own,us3d,own_corrupted}`` in root.json; a sparsity mask limits
labels to the first N images; corrupted runs also load the clean labels for
eval, and a no-cars label set when present.
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.datasets.satnerf_dataset import SatNeRFDataset
from satnerf_torch.io.image import load_cls_tensor


class SemanticDataset(SatNeRFDataset):
    def __init__(self, cfg, dataset_name: str, split: str) -> None:
        super().__init__(cfg, dataset_name, split)
        sem_type = cfg.pipeline.semantic_dataset_type
        self.semantic_dataset_name = f"semantic_dp_{sem_type}"
        assert {self.semantic_dataset_name, "semantic_cls_labels"} <= set(
            self.root
        ), "dataset has no semantic annotations for this pipeline"
        self.semantic_dp = os.path.join(
            cfg.run.dataset_dp, self.root[self.semantic_dataset_name]
        )
        self.labels_are_corrupted = "corrupted" in sem_type
        self.semantic_non_corrupted_dp = None
        if self.labels_are_corrupted:
            clean = "semantic_dp_" + sem_type[: -len("_corrupted")]
            self.semantic_non_corrupted_dp = os.path.join(
                cfg.run.dataset_dp, self.root[clean]
            )
        # no-cars labels are produced for the base variant only; corrupted
        # runs fall back to the clean no-cars set for eval comparisons
        self.semantic_no_cars_dp = None
        for key in (
            self.semantic_dataset_name + "_no_cars",
            "semantic_dp_" + sem_type.replace("_corrupted", "") + "_no_cars",
        ):
            if self.root.get(key):
                self.semantic_no_cars_dp = os.path.join(
                    cfg.run.dataset_dp, self.root[key]
                )
                break

        self.semantic_cls_labels: dict = self.root["semantic_cls_labels"]
        self.semantic_n_classes = len(self.semantic_cls_labels)
        self.car_cls_idx = None
        for k, v in self.semantic_cls_labels.items():
            if v == "cars":
                self.car_cls_idx = int(k)
        self.sparsity_n_images = cfg.pipeline.sparsity_n_images

    def _cls_fp(self, dp: str, meta: dict) -> str:
        return os.path.join(dp, meta["img"][: -len("RGB.tif")] + "CLS.tif")

    def _create_item(self, name, index, meta, load_from_cache) -> dict:
        item = super()._create_item(name, index, meta, load_from_cache)
        labels = load_cls_tensor(self._cls_fp(self.semantic_dp, meta))
        n = labels.shape[0]

        sparsity_mask = np.ones(n, dtype=bool)
        if self.split == "train" and 0 < self.sparsity_n_images <= index:
            sparsity_mask[:] = False

        item["semantic"] = labels
        item["semantic_sparsity_mask"] = sparsity_mask
        if self.semantic_non_corrupted_dp:
            item["semantic_non_corrupted"] = load_cls_tensor(
                self._cls_fp(self.semantic_non_corrupted_dp, meta)
            )
        if self.semantic_no_cars_dp:
            item["semantic_no_cars"] = load_cls_tensor(
                self._cls_fp(self.semantic_no_cars_dp, meta)
            )
        return item
