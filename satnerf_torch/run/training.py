"""Training entry point (port of ``satnerf_tpu/run/training.py``). Usage:

    python -m satnerf_torch.run.training start_training RUN_TOML PIPELINE_TOML
        [--device cpu] [--dist-backend nccl|gloo]
    python -m satnerf_torch.run.training start_assigned_ids_from_automated EXP_DP ID,ID
        [--device cpu]

The device defaults to ``cuda`` and raises without a GPU; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU.

With ``data_parallel = N > 1`` in the run TOML the run trains over N ranks
(``parallel/``): under torchrun (``torchrun --nproc-per-node N -m
satnerf_torch.run.training start_training ...``) each process joins the
group; without it the CLI starts N local ranks itself, rank r on
``cuda:r``. ``--dist-backend`` is ``nccl`` (the default, one card per rank)
or ``gloo`` (the CPU, or several ranks sharing one card).
"""

from __future__ import annotations

import gc
import os
import sys

import torch
import torch.distributed as dist

from satnerf_torch.configs import MainConfig, load_configs
from satnerf_torch.device import resolve_device
from satnerf_torch.logger import logger
from satnerf_torch.parallel.multihost import launch_local_ranks, launched, process_group
from satnerf_torch.pipelines import load_pipeline
from satnerf_torch.train.loop import Trainer

_PRECISION = {"highest": "highest", "high": "high", "default": "medium",
              "medium": "medium"}


def apply_matmul_precision(precision: str) -> None:
    """``RunConfig.matmul_precision`` -> ``torch.set_float32_matmul_precision``
    ("highest", "high"; "default" -> "medium"). It reaches library matmuls
    only; the kernels keep their own compute dtype."""
    torch.set_float32_matmul_precision(_PRECISION.get(precision, "high"))


def start_training(run_fp: str, pipeline_fp: str, device=None, log_every: int = 100,
                   dist_backend: str = "nccl"):
    """-> (pipeline, state, trainer) of a finished run (this rank's, under
    data parallelism)."""
    return start_training_cfgs(load_configs(run_fp, pipeline_fp), device, log_every,
                               dist_backend)


def start_training_cfgs(cfgs: MainConfig, device=None, log_every: int = 100,
                        dist_backend: str = "nccl"):
    """Train ``cfgs``; with ``data_parallel > 1`` (or torchrun's environment)
    inside the process group, which is torn down at the end."""
    with process_group(cfgs.run.data_parallel, dist_backend):
        if not dist.is_initialized():  # ranks share the directory rank 0 makes
            cfgs.create_run_dp()
        return start_pipeline_cfgs(cfgs, device, log_every)


def prepare_trainer(cfgs: MainConfig, device=None, log_every: int = 100) -> Trainer:
    """The run's pipeline with its datasets loaded, and its Trainer. In a
    process group the Trainer makes the run directory and loads the
    datasets (rank 0 first) when it starts."""
    dev = resolve_device(device)  # before any work: no GPU, no run
    if cfgs.run.deterministic:
        # the kernels' sums are atomics-free and every random draw comes from
        # run.seed (the samplers and the per-step generator)
        logger.info("Run", f"deterministic run with seed {cfgs.run.seed}")
    apply_matmul_precision(cfgs.run.matmul_precision)
    pipeline = load_pipeline(cfgs)
    if not dist.is_initialized():
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
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def split_option(argv: list, name: str, default=None) -> tuple:
    """(argv without ``name X``, X or ``default``)."""
    if name not in argv:
        return argv, default
    i = argv.index(name)
    return argv[:i] + argv[i + 2:], argv[i + 1]


def run_ranks(module: str, argv: list, data_parallel: int) -> int | None:
    """Start ``data_parallel`` local ranks of ``python -m module argv`` when
    the run asks for more than one and no launcher started this process ->
    their exit code, else None (this process trains)."""
    if data_parallel > 1 and not launched():
        logger.info("Run", f"starting {data_parallel} local ranks")
        return launch_local_ranks(module, argv, data_parallel)
    return None


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    full = list(argv)
    argv, device = split_option(argv, "--device")
    argv, backend = split_option(argv, "--dist-backend", "nccl")
    if not argv:
        print(__doc__)
        return 1
    cmd, *args = argv
    if cmd == "start_training":
        cfgs = load_configs(*args)
        rc = run_ranks("satnerf_torch.run.training", full, cfgs.run.data_parallel)
        if rc is not None:
            return rc
        start_training_cfgs(cfgs, device, dist_backend=backend)
        return 0
    if cmd != "start_assigned_ids_from_automated":
        raise SystemExit(f"unknown command {cmd!r}")
    start_assigned_ids_from_automated(*args, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
