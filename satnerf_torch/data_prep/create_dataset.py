"""Dataset-construction entry point: sequential processing steps over shared state
(a copy of ``satnerf_tpu/data_prep/create_dataset.py``; every registry name
resolves to a module of ``satnerf_torch.data_prep.steps``, and each step
logs the host seconds of its skip check, run and state update, its import
left out: ``step <file> ran|skipped|disabled in <s> s``).

ref: data_prep/create_dataset.py:12-67 — each step is constructed with
(cfg, step_cfg, state), may be lazily skipped, runs, then updates the shared
state dict. Steps resolve from the in-package registry or from a dotted
module path exposing ``ProcessingStep``.

CLI: python -m satnerf_torch.data_prep.create_dataset <dataset_cfg.toml>
"""

from __future__ import annotations

import importlib
import json
import sys
import time

from satnerf_torch.data_prep.dataset_config import DatasetConfig, load_dataset_config
from satnerf_torch.logger import logger

STEP_REGISTRY = {
    "adapter_dfc2019": "satnerf_torch.data_prep.steps.adapter_dfc2019",
    "step_cropping": "satnerf_torch.data_prep.steps.step_cropping",
    "step_bundle_adjustment": "satnerf_torch.data_prep.steps.step_bundle_adjustment",
    "step_finish_meta_extraction": "satnerf_torch.data_prep.steps.step_finish_meta_extraction",
    "step_create_root_file": "satnerf_torch.data_prep.steps.step_create_root_file",
    "step_semantic": "satnerf_torch.data_prep.steps.step_semantic",
}


def run_processing_step(step_cfg, cfg: DatasetConfig, state: dict) -> None:
    module_path = STEP_REGISTRY.get(step_cfg.file, step_cfg.file)
    if step_cfg.from_dir:
        sys.path.append(step_cfg.from_dir)
    logger.info("DataPrep", f"processing step: {module_path}")
    module = importlib.import_module(module_path)
    step = module.ProcessingStep(cfg, step_cfg, state)
    t0 = time.perf_counter()  # the step's work, past its import

    outcome = "disabled"
    if step_cfg.enabled:
        if cfg.general.lazy and step.can_be_skipped(cfg, state):
            logger.info("DataPrep", "skipped (lazy, outputs exist)")
            outcome = "skipped"
        else:
            step.run(cfg, state)
            outcome = "ran"
    step.update_state(cfg, state, step_cfg.enabled)
    logger.info("DataPrep", f"state: {json.dumps(state, default=str)}")
    logger.info("DataPrep", f"step {step_cfg.file} {outcome} in "
                            f"{time.perf_counter() - t0:.3f} s")


def create_dataset(cfg: DatasetConfig) -> dict:
    state: dict = {}
    for step in cfg.steps:
        run_processing_step(step, cfg, state)
    return state


def run_create_dataset(cfg_fp: str) -> dict:
    cfg = load_dataset_config(cfg_fp)
    return create_dataset(cfg)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    run_create_dataset(argv[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
