"""Four-scene workflow: the reference's primary user loop, end to end
(port of the JAX package's ``tools/four_scenes.py``).

The reference trains one experiment per DFC2019 area (JAX_004 / JAX_068 /
JAX_214 / JAX_260: suburban, downtown high-rise, industrial, low
residential) and compares the areas with ``eval/gather_eval.py``. This tool
generates four synthetic scenes with distinct regimes (building-height band,
sun-elevation band, layout seed), runs them through the sweep runner
(``run/automated_training.py``, in turn in this process on one device), runs
the eval battery over the sweep's experiment directory, and leaves one
gathered table spanning all scenes.

Usage:
  python -m satnerf_torch.tools.four_scenes <out_root> [--steps N] [--img-size S]
      [--scenes A,B,C,D] [--skip-train] [--batch B] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a GPU. The default 8x256
field (the JAX tool's) runs K1 with 128-wide heads on the card.
``steps_per_dispatch`` in the run TOML (8) runs blocks of
8 replays of one captured step on the card and 8 calls on the CPU
(``train/dispatch.py``).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

# scene regimes, mimicking the DFC2019 areas' variety
SCENES = {
    "SYN_SUBURB": dict(seed=11, height_scale=1.0, sun_el_range=(35.0, 70.0)),
    "SYN_DOWNTOWN": dict(seed=22, height_scale=2.5, sun_el_range=(35.0, 70.0)),
    "SYN_LOWSUN": dict(seed=33, height_scale=1.0, sun_el_range=(22.0, 40.0)),
    "SYN_RESIDENT": dict(seed=44, height_scale=0.5, sun_el_range=(50.0, 80.0)),
}

RUN_TOML = """\
max_train_steps = {steps}
check_val_every_n_epoch = 1000000
num_sanity_val_steps = 0
deterministic = true
seed = 7
steps_per_dispatch = 8
dataset_name = "PLACEHOLDER"
datasets_dp = "{root}/datasets"
cache_dp = "{root}/cache"
workspace_dp = "{root}/training"
"""

PIPE_TOML = """\
pipeline = "rs_semantic"
n_samples = {n_samples}
fc_layers = 8
fc_units = {units}
fc_skips = [4]
batch_size = {batch}
compute_dtype = "bfloat16"
depth_enabled = true
use_car_reg_loss = true
car_reg_loss_start = 3
lambda_c = 1.0
ignore_car_index = false
"""

EXP_TOML_HEADER = """\
run_cfg = "run.toml"
experiment_category = "four_scenes"
"""

EXP_ENTRY = """\
[[experiments]]
pipeline_name = "rs_semantic.toml"
id = "{scene}"
[experiments.run]
dataset_name = "{scene}"
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_root")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--img-size", type=int, default=160)
    ap.add_argument("--n-train", type=int, default=6)
    ap.add_argument("--n-test", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--units", type=int, default=256)
    ap.add_argument("--n-samples", type=int, default=32)
    ap.add_argument("--tie-points", type=int, default=3000)
    ap.add_argument("--scenes", default=",".join(SCENES),
                    help="subset of scene names to run")
    ap.add_argument("--skip-train", action="store_true",
                    help="only (re-)run the eval battery + gather")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from satnerf_torch.device import resolve_device

    dev = resolve_device(args.device)  # no GPU, no scenes and no runs

    root = os.path.abspath(args.out_root)
    scenes = [s for s in args.scenes.split(",") if s]
    unknown = set(scenes) - set(SCENES)
    assert not unknown, f"unknown scenes {unknown}; choose from {set(SCENES)}"

    from satnerf_torch.datasets.synthetic import generate_scene

    for name in scenes:
        scene_dp = os.path.join(root, "datasets", name)
        if os.path.isfile(os.path.join(scene_dp, "root.json")):
            continue
        print(f"[four_scenes] generating {name} {SCENES[name]}", flush=True)
        generate_scene(
            scene_dp, n_train=args.n_train, n_test=args.n_test,
            img_size=args.img_size, n_tie_points=args.tie_points,
            aoi_name=name, **SCENES[name],
        )

    cfgs_dp = os.path.join(root, "cfgs")
    os.makedirs(cfgs_dp, exist_ok=True)
    with open(os.path.join(cfgs_dp, "run.toml"), "w") as f:
        f.write(RUN_TOML.format(root=root, steps=args.steps))
    with open(os.path.join(cfgs_dp, "rs_semantic.toml"), "w") as f:
        f.write(PIPE_TOML.format(batch=args.batch, units=args.units,
                                 n_samples=args.n_samples))
    exp_fp = os.path.join(cfgs_dp, "experiment.toml")
    with open(exp_fp, "w") as f:
        f.write(EXP_TOML_HEADER)
        for name in scenes:
            f.write(EXP_ENTRY.format(scene=name))

    out_dp = os.path.join(root, "out")
    if not args.skip_train:
        from satnerf_torch.run.automated_training import launch

        launch(exp_fp, out_dp, device=dev)

    # the sweep nests runs under workspace/<category>/<experiment-name>/;
    # discover the dir rather than hard-coding the category normalisation
    cands = sorted(
        dp for dp in glob.glob(os.path.join(root, "training", "*", "experiment"))
        if os.path.isdir(dp)
    )
    assert cands, f"no sweep run dir under {root}/training/*/experiment"
    exp_runs_dp = cands[-1]

    from satnerf_torch.eval.eval import eval_all

    battery_dp = os.path.join(root, "battery")
    os.makedirs(battery_dp, exist_ok=True)
    eval_all(exp_runs_dp, battery_dp, splits="test", device=dev)

    # surface the cross-scene table
    gathered = None
    for dirpath, _, files in os.walk(battery_dp):
        if "gathered.txt" in files:
            gathered = os.path.join(dirpath, "gathered.txt")
            break
    assert gathered, "gather produced no table"
    final_fp = os.path.join(root, "gathered_four_scenes.txt")
    shutil.copyfile(gathered, final_fp)
    print(f"[four_scenes] cross-scene table: {final_fp}", flush=True)
    with open(final_fp) as f:
        print(f.read(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
