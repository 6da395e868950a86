"""Training entry point (port of ``satnerf_tpu/run/training.py``). Usage:

    python -m satnerf_torch.run.training start_training RUN_TOML PIPELINE_TOML [--device cpu]
    python -m satnerf_torch.run.training start_assigned_ids_from_automated EXP_DP ID,ID [--device cpu]

The device defaults to ``cuda`` and raises without a GPU; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

from satnerf_torch.configs import MainConfig, load_configs
from satnerf_torch.device import resolve_device
from satnerf_torch.logger import logger
from satnerf_torch.pipelines import load_pipeline
from satnerf_torch.train.loop import Trainer

_PRECISION = {"highest": "highest", "high": "high", "default": "medium",
              "medium": "medium"}


def apply_matmul_precision(precision: str) -> None:
    """``RunConfig.matmul_precision`` -> ``torch.set_float32_matmul_precision``
    ("highest", "high"; "default" -> "medium"). It reaches library matmuls
    only; the kernels keep their own compute dtype."""
    torch.set_float32_matmul_precision(_PRECISION.get(precision, "high"))


def start_training(run_fp: str, pipeline_fp: str, device=None, log_every: int = 100):
    """-> (pipeline, state, trainer) of a finished run."""
    return start_training_cfgs(load_configs(run_fp, pipeline_fp), device, log_every)


def start_training_cfgs(cfgs: MainConfig, device=None, log_every: int = 100):
    cfgs.create_run_dp()
    return start_pipeline_cfgs(cfgs, device, log_every)


def prepare_trainer(cfgs: MainConfig, device=None, log_every: int = 100) -> Trainer:
    """The run's pipeline with its datasets loaded, and its Trainer."""
    dev = resolve_device(device)  # before any work: no GPU, no run
    if cfgs.run.deterministic:
        # the kernels' sums are atomics-free and every random draw comes from
        # run.seed (the samplers and the per-step generator)
        logger.info("Run", f"deterministic run with seed {cfgs.run.seed}")
    apply_matmul_precision(cfgs.run.matmul_precision)
    pipeline = load_pipeline(cfgs)
    pipeline.prepare_run()
    pipeline.load_datasets()
    return Trainer(pipeline, log_every=log_every, device=dev)


def start_pipeline_cfgs(cfgs: MainConfig, device=None, log_every: int = 100):
    trainer = prepare_trainer(cfgs, device, log_every)
    state = trainer.fit()
    return trainer.pipeline, state, trainer


def start_assigned_ids_from_automated(experiment_dp: str, ids: str, device=None):
    """Run a sequence of derived experiment configs on this host."""
    for exp_id in str(ids).split(","):
        exp_id = exp_id.strip()
        run_fp = os.path.join(experiment_dp, exp_id, "run.toml")
        pipe_fp = os.path.join(experiment_dp, exp_id, "pipeline.toml")
        logger.info("Sweep", f"starting experiment {exp_id}")
        start_training(run_fp, pipe_fp, device)
        gc.collect()
        time.sleep(5)  # let the device settle between experiments


def split_device(argv: list) -> tuple:
    """(argv without ``--device X``, X or None)."""
    if "--device" not in argv:
        return argv, None
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:], argv[i + 1]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    argv, device = split_device(argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, *args = argv
    fn = {
        "start_training": start_training,
        "start_assigned_ids_from_automated": start_assigned_ids_from_automated,
    }[cmd]
    fn(*args, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
