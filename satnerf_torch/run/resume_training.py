"""Resume a training run from its run directory (port of
``satnerf_tpu/run/resume_training.py``). Usage:

    python -m satnerf_torch.run.resume_training resume <run_dp> [--device cpu]
"""

from __future__ import annotations

import sys

from satnerf_torch.configs import load_configs_from_logs
from satnerf_torch.device import resolve_device
from satnerf_torch.logger import logger
from satnerf_torch.pipelines import load_pipeline
from satnerf_torch.run.training import apply_matmul_precision, split_device
from satnerf_torch.train.loop import Trainer


def prepare_resume(run_dp: str, device=None, log_every: int = 100) -> Trainer:
    """The Trainer that continues ``run_dp`` from its ``last`` checkpoint."""
    dev = resolve_device(device)
    cfgs = load_configs_from_logs(run_dp)
    cfgs.run.resume_from_ckpoint = True
    logger.info("Resume", f"resuming run {run_dp}")
    # the run's matmul precision, as the first session had it
    apply_matmul_precision(cfgs.run.matmul_precision)
    pipeline = load_pipeline(cfgs)
    pipeline.load_datasets()
    return Trainer(pipeline, log_every=log_every, device=dev)


def resume(run_dp: str, device=None, log_every: int = 100):
    """Continue ``run_dp`` to its ``max_train_steps`` -> the final state."""
    return prepare_resume(run_dp, device, log_every).fit()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    argv, device = split_device(argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, *args = argv
    {"resume": resume}[cmd](*args, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
