"""Automated experiment sweeps: experiment TOML -> derived configs -> launch
(port of ``satnerf_tpu/run/automated_training.py``).

ref: run/automated_training.py:13-209 — the reference assigns experiment ids
round-robin to free GPUs and generates a tmux session, one window per GPU.
Here experiments are derived the same way (global pipeline/run overrides +
per-experiment overrides, dumped configs per id), and the launcher either

* runs the queues sequentially in this process on the local card, or
* writes a shell script with one line per worker, each an independent
  training process pinned to card ``<worker>`` by ``CUDA_VISIBLE_DEVICES``
  (the reference's process per GPU).

CLI:
    python -m satnerf_torch.run.automated_training prepare <experiment.toml> <out_dp>
    python -m satnerf_torch.run.automated_training launch  <experiment.toml> <out_dp>
        [--workers N] [--script-only true] [--device cpu]
"""

from __future__ import annotations

import os
import stat
import sys

from satnerf_torch.configs import MainConfig, load_configs, read_toml
from satnerf_torch.logger import logger


def convert_experiments_to_cfgs(experiment_fp: str, output_dp: str) -> list[str]:
    """Derive per-experiment run/pipeline configs (ref: automated:85-135)."""
    exp = read_toml(experiment_fp)
    base_dir = exp.get("cfgs_base_dir", os.path.dirname(experiment_fp))
    run_ids = {str(i) for i in exp.get("run_ids") or ()} or None
    name = os.path.splitext(os.path.basename(experiment_fp))[0]

    prepared = []
    for entry in exp["experiments"]:
        exp_id = str(entry["id"])
        assert exp_id not in prepared, f"duplicate experiment id {exp_id}"
        if run_ids and exp_id not in run_ids:
            continue

        run_fp = os.path.join(base_dir, exp["run_cfg"])
        if not os.path.isfile(run_fp):
            # don't let load_configs' interactive template bootstrap fire
            # here: it copies a placeholder TOML next to the experiment
            # file and exits 0, so a chained scheduler would proceed as if
            # the sweep had been prepared
            raise FileNotFoundError(
                f"sweep run_cfg {run_fp} does not exist (experiment "
                f"{exp_id} in {experiment_fp})"
            )
        cfg = load_configs(
            run_fp,
            os.path.join(base_dir, entry["pipeline_name"]),
        )
        if exp.get("dataset_name"):
            cfg.run.dataset_name = exp["dataset_name"]

        for scope_src in (exp, entry):
            for scope in ("pipeline", "run"):
                for key, value in (scope_src.get(scope) or {}).items():
                    target = getattr(cfg, scope)
                    assert hasattr(target, key), (
                        f"unknown cfg entry {scope}.{key}"
                    )
                    setattr(target, key, value)

        cfg.run.experiment_category = os.path.join(
            exp.get("experiment_category", ""), name
        ).strip("/")
        cfg.run.run_name_postfix += f"_exp{exp_id}"

        exp_dp = os.path.join(output_dp, exp_id)
        os.makedirs(exp_dp, exist_ok=True)
        MainConfig(cfg.run, cfg.pipeline).dump(exp_dp)
        prepared.append(exp_id)
    logger.info("Sweep", f"prepared experiments: {prepared}")
    return prepared


def assign_round_robin(ids: list[str], workers: int) -> list[list[str]]:
    """Queue per worker slot (the reference's id->GPU assignment,
    ref: automated:68-82)."""
    queues: list[list[str]] = [[] for _ in range(max(workers, 1))]
    for i, exp_id in enumerate(ids):
        queues[i % len(queues)].append(exp_id)
    return queues


def create_launch_script(output_dp: str, queues: list[list[str]]) -> str:
    """One launch line per worker, pinned to card ``<worker>``
    (tmux-script replacement, ref: automated:138-209)."""
    lines = ["#!/bin/sh", "# generated by satnerf_torch.run.automated_training"]
    for worker, queue in enumerate(queues):
        if not queue:
            continue
        ids = ",".join(queue)
        lines.append(
            f"CUDA_VISIBLE_DEVICES={worker} python -m satnerf_torch.run.training "
            f"start_assigned_ids_from_automated {output_dp} {ids} "
            f"> {output_dp}/worker_{worker}.log 2>&1 &"
        )
    lines.append("wait")
    fp = os.path.join(output_dp, "launch.sh")
    with open(fp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.chmod(fp, os.stat(fp).st_mode | stat.S_IEXEC)
    return fp


def prepare(experiment_fp: str, output_dp: str):
    os.makedirs(output_dp, exist_ok=True)
    return convert_experiments_to_cfgs(experiment_fp, output_dp)


def launch(
    experiment_fp: str,
    output_dp: str,
    workers: int = 1,
    script_only: str = "false",
    device=None,
):
    """Prepare the sweep and write its launch script; unless
    ``script_only``, run every queue in turn in this process on ``device``
    (None: the card) -> the script's path."""
    ids = prepare(experiment_fp, output_dp)
    queues = assign_round_robin(ids, int(workers))
    script_fp = create_launch_script(output_dp, queues)
    if str(script_only).lower() in ("1", "true", "yes"):
        logger.info("Sweep", f"launch script written: {script_fp}")
        return script_fp
    from satnerf_torch.run.training import start_assigned_ids_from_automated

    for queue in queues:
        if queue:
            start_assigned_ids_from_automated(output_dp, ",".join(queue), device=device)
    return script_fp


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd, *rest = argv
    from satnerf_torch.eval.eval_nerf import _parse

    args, kwargs = _parse(rest)
    {"prepare": prepare, "launch": launch}[cmd](*args, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
