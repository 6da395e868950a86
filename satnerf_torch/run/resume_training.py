"""Resume a training run from its run directory (port of
``satnerf_tpu/run/resume_training.py``). Usage:

    python -m satnerf_torch.run.resume_training resume <run_dp> [--device cpu]
        [--dist-backend nccl|gloo]

A run with ``data_parallel = N > 1`` resumes over N ranks, as
``run.training`` starts it: every rank restores the same ``last``
checkpoint onto its own device.
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from satnerf_torch.configs import load_configs_from_logs
from satnerf_torch.device import resolve_device
from satnerf_torch.logger import logger
from satnerf_torch.parallel.multihost import process_group
from satnerf_torch.pipelines import load_pipeline
from satnerf_torch.run.training import (
    apply_matmul_precision,
    run_ranks,
    split_option,
)
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
    if not dist.is_initialized():  # else the Trainer loads them rank by rank
        pipeline.load_datasets()
    return Trainer(pipeline, log_every=log_every, device=dev)


def resume(run_dp: str, device=None, log_every: int = 100, dist_backend: str = "nccl"):
    """Continue ``run_dp`` to its ``max_train_steps`` -> the final state (of
    this rank, under data parallelism)."""
    data_parallel = load_configs_from_logs(run_dp).run.data_parallel
    with process_group(data_parallel, dist_backend):
        return prepare_resume(run_dp, device, log_every).fit()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    full = list(argv)
    argv, device = split_option(argv, "--device")
    argv, backend = split_option(argv, "--dist-backend", "nccl")
    if not argv:
        print(__doc__)
        return 1
    cmd, run_dp = argv
    if cmd != "resume":
        raise SystemExit(f"unknown command {cmd!r}")
    rc = run_ranks("satnerf_torch.run.resume_training", full,
                   load_configs_from_logs(run_dp).run.data_parallel)
    if rc is not None:
        return rc
    resume(run_dp, device=device, dist_backend=backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
