"""Shared helpers of the runnable examples: a small trained run.

Every example is self-sufficient: the first one to run trains a small
RS-Semantic model on a generated synthetic scene (a full root.json layout)
and later examples reuse the run directory. The workspace is
``<tmp>/satnerf_examples``; ``SATNERF_EXAMPLES_OUT`` moves it, and
``SATNERF_EXAMPLES_STEPS`` / ``SATNERF_EXAMPLES_IMG`` shrink the run (the
test suite's examples smoke test does).

The field is the JAX package's example's 2 x 128: its 64-wide heads are not a
multiple of 128, so on the card the trunk runs K3 (and K4 backward) and the
heads run layer by layer, as the JAX package runs its trunk kernel and XLA
heads.
"""

from __future__ import annotations

import argparse
import glob
import os
import tempfile


def parse_device(argv=None, description: str = "") -> str:
    """``--device cuda|cpu`` from ``argv`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv).device


def example_workspace() -> str:
    return os.environ.get("SATNERF_EXAMPLES_OUT",
                          os.path.join(tempfile.gettempdir(), "satnerf_examples"))


def get_or_train_run(steps: int | None = None, device=None) -> str:
    """Return a trained run directory, training one on ``device`` (None:
    the card) if none exists."""
    from satnerf_torch.device import resolve_device

    dev = resolve_device(device)
    steps = steps or int(os.environ.get("SATNERF_EXAMPLES_STEPS", 300))
    img = int(os.environ.get("SATNERF_EXAMPLES_IMG", 48))
    base = example_workspace()
    runs = sorted(glob.glob(os.path.join(base, "training", "*_rs_semantic*")))
    for run_dp in reversed(runs):
        if os.path.isfile(os.path.join(run_dp, "ckpoints", "last.ckpt")):
            return run_dp

    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    scene_dp = os.path.join(base, "datasets", "SYN_EX")
    if not os.path.isdir(scene_dp):
        generate_scene(scene_dp, n_train=3, n_test=1, img_size=img, n_tie_points=120)

    run = RunConfig(
        dataset_name="SYN_EX",
        datasets_dp=os.path.join(base, "datasets"),
        cache_dp=os.path.join(base, "cache"),
        workspace_dp=os.path.join(base, "training"),
        max_train_steps=steps,
        check_val_every_n_epoch=50,
        num_sanity_val_steps=0,
        seed=0,
    )
    pipe = RSSemanticConfig(
        n_samples=8, fc_layers=2, fc_units=128, fc_skips=[1],
        batch_size=512, render_chunk_size=4096, first_beta_epoch=1,
    )
    cfg = MainConfig(run, pipe)
    pipeline = load_pipeline(cfg)
    pipeline.prepare_run()
    pipeline.load_datasets()
    Trainer(pipeline, log_every=100, device=dev).fit()  # checkpoints "last" on finish
    return cfg.run.run_dp
