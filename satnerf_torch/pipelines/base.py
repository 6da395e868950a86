"""Pipeline classes: dataset wiring, the normalization handshake and the
step configs (port of ``satnerf_tpu/pipelines/base.py``).

A Pipeline owns host state only (configs, datasets, run dir); the device
state lives in the ``TrainState`` the training loop (train/loop.py) threads
through the step.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from satnerf_torch.configs import MainConfig, step_config_from_pipeline
from satnerf_torch.datasets import DepthDataset, SatNeRFDataset, SemanticDataset
from satnerf_torch.logger import logger


class Pipeline:
    """Base: RGB train/test datasets + normalization orchestration."""

    VARIANT = "nerf"

    def __init__(self, cfg: MainConfig) -> None:
        self.cfg = cfg
        self.datasets: dict = {}
        self.loaded = False

    # -- run dir ------------------------------------------------------------
    def prepare_run(self) -> str:
        run_dp = self.cfg.create_run_dp()
        self.cfg.dump(os.path.join(run_dp, "configs"))
        logger.attach_file_handler(run_dp)
        logger.info("Run", f"run directory: {run_dp}")
        return run_dp

    # -- datasets -------------------------------------------------------------
    def _rgb_dataset_cls(self):
        return SatNeRFDataset

    def _init_datasets(self) -> dict:
        cls = self._rgb_dataset_cls()
        d = {
            "rgb": cls(self.cfg, "rgb", "train"),
            "rgb_test": cls(self.cfg, "rgb", "test"),
        }
        if getattr(self.cfg.pipeline, "depth_enabled", False):
            d["depth"] = DepthDataset(self.cfg, "depth", "train")
        return d

    def load_datasets(self, write_cache: bool = True) -> None:
        """Load and normalise the datasets; ``write_cache=False`` leaves the
        dataset cache as it is (a data-parallel rank other than 0 reads the
        cache rank 0 wrote)."""
        self.datasets = self._init_datasets()
        rgb, rgb_test = self.datasets["rgb"], self.datasets["rgb_test"]
        rgb.load()
        rgb_test.load()
        combined = np.concatenate(
            [rgb.combined["rays"], rgb_test.combined["rays"]], axis=0
        )
        for ds in (rgb, rgb_test):
            ds.initialize_normalization(combined, save=write_cache)
            if write_cache:
                ds.save_to_cache()
            ds.normalize()
        if "depth" in self.datasets:
            depth = self.datasets["depth"]
            depth.initialize_normalization()  # from the cache written above
            depth.load()
        self.loaded = True

    # -- semantic metadata (overridden by RSSemanticPipeline) -------------------
    @property
    def n_classes(self) -> int:
        return 0

    @property
    def car_index(self) -> int:
        return -1

    @property
    def t_vocab(self) -> int:
        return getattr(self.cfg.pipeline, "t_embedding_vocab", 50)

    # -- visualizers ------------------------------------------------------------
    def visualizers(self) -> list:
        """The variant's visualizer set (``viz.default_visualizers``)."""
        from satnerf_torch.viz import default_visualizers

        return default_visualizers(
            self.cfg,
            semantic=self.VARIANT == "rs_semantic",
            has_sun=self.VARIANT != "nerf",
            has_beta=self.VARIANT in ("satnerf", "rs_semantic"),
        )

    # -- step configs -----------------------------------------------------------
    def step_config(self, steps_per_epoch: int, with_depth: bool | None = None,
                    device="cuda"):
        return step_config_from_pipeline(
            dataclasses.asdict(self.cfg.pipeline), steps_per_epoch,
            with_depth=with_depth, n_classes=max(self.n_classes, 1),
            car_index=self.car_index, device=device,
        )

    @property
    def ds_drop_step(self) -> int:
        """Step index where depth supervision stops."""
        p = self.cfg.pipeline
        if not getattr(p, "depth_enabled", False):
            return 0
        return int(round(p.depth_supervision_drop * self.cfg.run.max_train_steps))


class NerfPipeline(Pipeline):
    VARIANT = "nerf"


class SNerfPipeline(Pipeline):
    VARIANT = "snerf"


class SatNeRFPipeline(Pipeline):
    VARIANT = "satnerf"


class RSSemanticPipeline(Pipeline):
    VARIANT = "rs_semantic"

    def _rgb_dataset_cls(self):
        return SemanticDataset

    def _cls_labels(self) -> dict:
        """The semantic class map: from the loaded rgb dataset, else straight
        from the scene's root.json (cached)."""
        if self.datasets:
            return self.datasets["rgb"].semantic_cls_labels
        cached = getattr(self, "_cls_labels_cache", None)
        if cached is not None:
            return cached
        from satnerf_torch.io.json_io import read_json

        root_fp = os.path.join(self.cfg.run.dataset_dp, "root.json")
        try:
            root = read_json(root_fp)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"semantic class map needs the scene's root.json at {root_fp} "
                "(datasets not loaded and the trained dataset_dp is not "
                "reachable from here)"
            ) from e
        self._cls_labels_cache = root["semantic_cls_labels"]
        return self._cls_labels_cache

    @property
    def n_classes(self) -> int:
        return len(self._cls_labels())

    @property
    def car_index(self) -> int:
        for k, v in self._cls_labels().items():
            if v == "cars":
                return int(k)
        return -1


PIPELINES = {
    "nerf": NerfPipeline,
    "snerf": SNerfPipeline,
    "satnerf": SatNeRFPipeline,
    "rs_semantic": RSSemanticPipeline,
}


def load_pipeline(cfg: MainConfig) -> Pipeline:
    """The pipeline class of the config's variant."""
    return PIPELINES[cfg.pipeline.variant](cfg)
