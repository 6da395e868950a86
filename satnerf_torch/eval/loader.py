"""Load a trained run for offline evaluation and serving (port of
``satnerf_tpu/eval/loader.py``).

Rebuild the pipeline from the configs persisted in the run directory, read
one checkpoint (an epoch snapshot, else ``best``, else ``last``) and return
what the eval scripts and the render service need.
"""

from __future__ import annotations

import os
from dataclasses import replace

import torch

from satnerf_torch.configs import adapt_configs_for_inference, load_configs_from_logs
from satnerf_torch.device import resolve_device
from satnerf_torch.logger import logger
from satnerf_torch.models.import_params import lightning_params, resident_params
from satnerf_torch.pipelines import load_pipeline
from satnerf_torch.run.training import apply_matmul_precision
from satnerf_torch.train.checkpoint import find_ckpoint_fp


def load_run(run_dp: str, epoch: int | None = None, load_datasets: bool = True,
             device=None, ckpt: str | None = None):
    """-> (pipeline, params, rcfg, step).

    ``params`` holds ``Field`` modules and tables on ``device`` (None: the
    card), each field packed once for K1 or K3; ``rcfg`` is the render
    config of ``pipeline.step_config(1, with_depth=False)`` with solar
    correction off: no eval, viz or serve consumer reads the
    solar-correction pass, which exists for training losses only.
    """
    dev = resolve_device(device)
    cfgs = adapt_configs_for_inference(load_configs_from_logs(run_dp))
    # evaluate at the run's matmul precision, as its validation rendered
    apply_matmul_precision(cfgs.run.matmul_precision)

    ckpt_fp = find_ckpoint_fp(run_dp, epoch if (epoch or 0) > 0 else None, ckpt)
    raw = torch.load(ckpt_fp, map_location="cpu", weights_only=True)  # read once
    step = int(raw.get("step", 0))
    logger.info("Eval", f"restored {os.path.basename(ckpt_fp)} (step {step}) from {run_dp}")

    pipeline = load_pipeline(cfgs)
    if load_datasets:
        pipeline.load_datasets()
    scfg = pipeline.step_config(steps_per_epoch=1, with_depth=False, device=dev)
    rcfg = replace(scfg.render, solar_correction=False)
    params = resident_params(lightning_params(raw, ckpt_fp), rcfg, dev)
    return pipeline, params, rcfg, step
