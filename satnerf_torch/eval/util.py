"""Shared eval-CLI plumbing: output-dir resolution and experiment expansion
(port of ``satnerf_tpu/eval/util.py``).

The environment variables keep the JAX package's names, so a user's scripts
work with either package.
"""

from __future__ import annotations

import os

from satnerf_torch.configs import load_pipeline_toml as read_toml
from satnerf_torch.logger import logger

EVAL_DP_ENV = "SATNERF_TPU_EVAL_DP"
EVAL_DP_ENV_COMPAT = "SEMANTIC_SATNERF_EVAL_DP"  # the reference's name


def _is_single_training(dp: str) -> bool:
    return os.path.isdir(os.path.join(dp, "ckpoints")) or os.path.isdir(os.path.join(dp, "tb"))


def extract_experiment_category(training_dp: str) -> str | None:
    run_cfg_fp = os.path.join(training_dp, "configs", "run.toml")
    if not os.path.isfile(run_cfg_fp):
        return None
    return "_" + read_toml(run_cfg_fp).get("experiment_category", "")


def expand_input_files_for_experiments(input_dp: str, output_dp: str | None = None):
    """Single run dir -> [run]; experiment dir -> its run subdirs (those with
    ``configs/pipeline.toml``), sorted. Raises when there is none."""
    input_dp = input_dp.rstrip("/")
    if _is_single_training(input_dp):
        output = [input_dp]
    else:
        output = [
            os.path.join(input_dp, name)
            for name in sorted(os.listdir(input_dp))
            if os.path.isdir(os.path.join(input_dp, name))
            and os.path.isfile(os.path.join(input_dp, name, "configs", "pipeline.toml"))
        ]
    if not output:
        # a typo'd path must not "succeed" having evaluated nothing
        raise FileNotFoundError(
            f"{input_dp} is neither a run dir (ckpoints/) nor an "
            "experiment dir containing runs with configs/pipeline.toml"
        )
    category = extract_experiment_category(output[0])
    if category not in (None, "_") and output_dp is not None and output_dp != input_dp:
        output_dp = os.path.join(output_dp, category)
        os.makedirs(output_dp, exist_ok=True)
    return output, output_dp


def run_eval_script(run_eval_method, input_dp: str, output_dp: str | None = None,
                    split: str = "test", epoch: int = -1, skip_to_exp: int = 1, **kwargs):
    """Dispatch an eval method over one run or a whole experiment folder."""
    if output_dp is None:
        output_dp = os.getenv(EVAL_DP_ENV) or os.getenv(EVAL_DP_ENV_COMPAT)
        if not (output_dp and os.path.isdir(output_dp)):
            raise FileNotFoundError(f"no output_dp given and ${EVAL_DP_ENV} unset")
        logger.info("Setup", f"eval output dp from env: {output_dp}")
    else:
        os.makedirs(output_dp, exist_ok=True)

    inputs, output_dp = expand_input_files_for_experiments(input_dp, output_dp)
    for run_dp in inputs[skip_to_exp - 1:]:
        run_eval_method(run_dp, output_dp=output_dp, split=split.lower(), epoch=epoch, **kwargs)
