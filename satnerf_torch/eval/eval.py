"""Eval orchestrator: the full evaluation battery of a trained run (port of
``satnerf_tpu/eval/eval.py``).

The checkpoint is read once per worker and every image is rendered once,
its render fed to all three consumers (PSNR/SSIM/MAE, point clouds,
semantic metrics). Large scenes default to fresh short-lived worker
processes: one per split (or per ``--batch-images N`` images), per-image
partial results written atomically (a respawned worker skips finished
images; partials of another checkpoint step are stale and redone), a
heartbeat file, and a parent that SIGTERMs a stalled worker and respawns it.
A worker that exits because its batch is done (``EXIT_MORE_REMAIN``) has
made progress and does not use up a respawn: only failures and stalls
count (the reference counts every spawn, ADVICE.md:7).

Each partial also records the seconds its image spent in the render and in
each consumer (``"seconds"``); results.json does not carry them.

CLI: python -m satnerf_torch.eval.eval <run_or_experiment_dp> [output_dp]
     [--splits test,train] [--epoch N] [--isolate auto|inline|subprocess]
     [--batch-images N] [--stall-timeout-s S] [--chunk N] [--device cuda|cpu]
     output_dp defaults to $SATNERF_TPU_EVAL_DP, else
     <run_or_experiment_dp>/eval_battery.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from satnerf_torch.configs import load_pipeline_toml as read_toml
from satnerf_torch.device import resolve_device
from satnerf_torch.eval.eval_nerf import _with_running_means, evaluate_image
from satnerf_torch.eval.eval_semantic import evaluate_semantic_image, write_semantic_results
from satnerf_torch.eval.extract_pointcloud import export_image_clouds
from satnerf_torch.eval.gather_eval import gather
from satnerf_torch.eval.loader import load_run
from satnerf_torch.eval.util import (
    EVAL_DP_ENV,
    EVAL_DP_ENV_COMPAT,
    expand_input_files_for_experiments,
)
from satnerf_torch.logger import logger
from satnerf_torch.render.renderer import render_image_chunked

# a worker that made progress but has images left exits with this code so
# the parent respawns a fresh process (bounded process age)
EXIT_MORE_REMAIN = 3


def _is_semantic(run_dp: str) -> bool:
    fp = os.path.join(run_dp, "configs", "pipeline.toml")
    return "rs_semantic" in read_toml(fp).get("pipeline", "")


def _scene_is_large(run_dp: str) -> bool:
    """The isolate="auto" choice, without building ray stores: the run's
    dataset root.json and its first train meta give the image count and
    size."""
    try:
        run_cfg = read_toml(os.path.join(run_dp, "configs", "run.toml"))
        ds_dp = os.path.join(run_cfg["datasets_dp"], run_cfg["dataset_name"])
        with open(os.path.join(ds_dp, "root.json")) as f:
            root = json.load(f)
        n_images = len(root.get("train_split", [])) + len(root.get("test_split", []))
        with open(os.path.join(ds_dp, root["meta_dp"], root["train_split"][0])) as f:
            meta = json.load(f)
        return meta["width"] * meta["height"] >= 512 * 512 or n_images >= 16
    except (OSError, KeyError, IndexError, ValueError):
        return False


def _partial_dp(output_dp: str, run_name: str, split: str) -> str:
    return os.path.join(output_dp, run_name, "partial", split)


def _eval_split(pipeline, params, rcfg, step, run_dp, output_dp, split, chunk: int = 16384,
                max_images: int = 0, device=None) -> bool:
    """Evaluate one split with per-image resumable partials.

    Renders every image not yet covered by a partial of this step, feeding
    each render to all consumers, then (the split complete) merges the
    partials into the split's results.json. Returns True when the split is
    complete, False when ``max_images`` stopped it early (more remain).
    """
    run_dp = run_dp.rstrip("/")
    run_name = os.path.basename(run_dp)
    semantic = _is_semantic(run_dp)
    corrupted = "corrupted" in getattr(pipeline.cfg.pipeline, "semantic_dataset_type", "")
    dataset = pipeline.datasets["rgb" if split == "train" else "rgb_test"]
    nerf_dp = os.path.join(output_dp, run_name, "eval", split)
    pc_dp = os.path.join(output_dp, run_name, "pointclouds", split)
    sem_dp = os.path.join(output_dp, run_name, "eval_semantic", split)
    partial_dp = _partial_dp(output_dp, run_name, split)
    for dp in (nerf_dp, pc_dp, partial_dp) + ((sem_dp,) if semantic else ()):
        os.makedirs(dp, exist_ok=True)
    heartbeat_fp = os.path.join(partial_dp, ".heartbeat")

    # the metrics skip the prepended train view of the test split; its
    # partial still exists, so a resume skips its render
    start = 1 if split == "test" else 0
    processed = 0
    for img_idx in range(len(dataset.data)):
        img = dataset.image_item(img_idx)
        partial_fp = os.path.join(partial_dp, f"{img['name']}.json")
        if os.path.isfile(partial_fp):
            try:
                with open(partial_fp) as f:
                    if json.load(f).get("step") == int(step):
                        continue
            except (json.JSONDecodeError, OSError):
                pass
        if max_images and processed >= max_images:
            return False
        clock = time.monotonic
        t = clock()
        res = render_image_chunked(params, rcfg, img["rays"], img["extras"], chunk=chunk,
                                   device=device)
        seconds = {"render": clock() - t}
        t = clock()
        # point clouds cover every item, the prepended train view too
        export_image_clouds(dataset, img, res, pc_dp, step)
        seconds["clouds"] = clock() - t
        entry = {"order": img_idx, "step": int(step), "nerf": None, "sem": None, "cm": None}
        if img_idx >= start:
            t = clock()
            entry["nerf"] = evaluate_image(dataset, img, res, nerf_dp, step)
            seconds["psnr_ssim_dsm_mae"] = clock() - t
            if semantic:
                t = clock()
                sem_entry, cm_raw = evaluate_semantic_image(dataset, img, res, sem_dp, corrupted)
                entry["sem"] = sem_entry
                entry["cm"] = np.asarray(cm_raw).tolist()
                seconds["semantic"] = clock() - t
        entry["seconds"] = seconds
        tmp = partial_fp + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f)
        os.replace(tmp, partial_fp)  # atomic: a killed worker leaves no truncated partial
        with open(heartbeat_fp, "w") as f:
            f.write(f"{img['name']} t={time.time():.0f}\n")
        processed += 1
        logger.info("EvalAll", f"{run_name} [{split}] {img['name']} done")

    # split complete -> merge the partials into the published results
    nerf_results: dict = {}
    sem_results: dict = {}
    n_cls = dataset.semantic_n_classes if semantic else 0
    cm_split = np.zeros((n_cls, n_cls)) if semantic else None
    entries = []
    for fn in os.listdir(partial_dp):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(partial_dp, fn)) as f:
            entry = json.load(f)
        if entry.get("step") != int(step):
            continue  # left over from another checkpoint
        entries.append((fn[: -len(".json")], entry))
    for name, entry in sorted(entries, key=lambda kv: kv[1].get("order", 0)):
        if entry["nerf"] is not None:
            nerf_results[name] = entry["nerf"]
        if semantic and entry["sem"] is not None:
            sem_results[name] = entry["sem"]
            cm_split += np.asarray(entry["cm"])
    with open(os.path.join(nerf_dp, "results.json"), "w") as f:
        json.dump(_with_running_means(nerf_results), f, indent=4)
    if semantic:
        write_semantic_results(sem_results, cm_split,
                               list(dataset.semantic_cls_labels.values()), sem_dp)
    return True


def _worker(run_dp, output_dp, split, epoch=-1, chunk=16384, max_images=0, device=None):
    """Fresh-process worker: evaluate up to max_images not-yet-done images
    of one split, then exit (0 = split complete, EXIT_MORE_REMAIN = call
    again). Resume comes from the on-disk partials."""
    pipeline, params, rcfg, step = load_run(run_dp, epoch, device=device)
    done = _eval_split(pipeline, params, rcfg, step, run_dp, output_dp, split, chunk=chunk,
                       max_images=max_images, device=device)
    return 0 if done else EXIT_MORE_REMAIN


def _run_split_isolated(run_dp, output_dp, split, epoch, chunk, batch_images, stall_timeout_s,
                        max_respawns: int = 25, max_failures: int = 3, device="cuda"):
    """Parent side: spawn fresh worker processes for one split until it
    reports complete; SIGTERM a worker whose heartbeat goes stale (stalled
    inside a device call) and respawn it. Finished images are never
    rendered again (per-image partials). A worker that stops at its batch
    boundary (``EXIT_MORE_REMAIN``) made progress and is replaced without
    using up a respawn; a failure or a stall uses one up, and raises after
    ``max_failures`` of them or past ``max_respawns``."""
    run_name = os.path.basename(run_dp.rstrip("/"))
    hb_fp = os.path.join(_partial_dp(output_dp, run_name, split), ".heartbeat")
    cmd = [sys.executable, "-m", "satnerf_torch.eval.eval", run_dp, output_dp,
           "--worker", "true", "--split", split, "--epoch", str(epoch), "--chunk", str(chunk),
           "--batch-images", str(batch_images), "--device", str(device)]
    failures = 0
    while True:
        t_start = time.time()
        proc = subprocess.Popen(cmd)
        stalled = False
        while True:
            try:
                proc.wait(timeout=min(5.0, stall_timeout_s))
                break
            except subprocess.TimeoutExpired:
                pass
            hb = os.path.getmtime(hb_fp) if os.path.isfile(hb_fp) else 0.0
            if time.time() - max(hb, t_start) > stall_timeout_s:
                stalled = True
                logger.warning("EvalAll", f"{run_name} [{split}] worker stalled "
                                          f"({stall_timeout_s:.0f}s without progress); SIGTERM")
                # SIGTERM first and wait: a worker inside a device call
                # unwinds on SIGTERM; SIGKILL only if it does not
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(180.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                break
        rc = proc.returncode
        if rc == 0:
            return
        if rc == EXIT_MORE_REMAIN and not stalled:
            continue  # a healthy batch boundary: a fresh worker, no respawn used
        failures += 1
        logger.warning("EvalAll", f"{run_name} [{split}] worker "
                       + ("stalled" if stalled else f"failed (rc={rc})")
                       + f"; respawning ({failures}/{max_failures})")
        if failures >= max_failures or failures > max_respawns:
            raise RuntimeError(f"eval worker for {run_name} [{split}] failed or stalled "
                               f"{failures} times; see logs")


def eval_all(input_dp: str, output_dp: str | None = None, splits=("train", "test"),
             epoch: int = -1, chunk: int = 16384, isolate: str = "auto", batch_images: int = 0,
             stall_timeout_s: float = 900.0, device=None):
    """Evaluate every run under ``input_dp`` (one run dir or an experiment
    dir) on ``splits`` and write the gathered tables."""
    dev = resolve_device(device)  # no GPU, no battery: before any output
    # validate the input before creating any output tree, so a typo'd run
    # path fails fast instead of scattering empty directories
    input_dp = os.path.abspath(input_dp)
    if not os.path.isdir(input_dp):
        raise FileNotFoundError(f"run/experiment dir not found: {input_dp}")
    env_output = os.getenv(EVAL_DP_ENV) or os.getenv(EVAL_DP_ENV_COMPAT)
    if output_dp is None and env_output:
        # an environment-given target is a shared eval area made
        # beforehand: a typo fails rather than creating a new tree
        output_dp = env_output
        if not os.path.isdir(output_dp):
            raise FileNotFoundError(f"${EVAL_DP_ENV}={output_dp} is not a directory")
    if output_dp is None:
        output_dp = os.path.join(input_dp, "eval_battery")  # self-contained in the run
    output_dp = os.path.abspath(output_dp)
    os.makedirs(output_dp, exist_ok=True)
    if isinstance(splits, str):
        splits = tuple(s for s in splits.split(",") if s)
    if isolate not in ("auto", "inline", "subprocess"):
        raise ValueError(f"isolate must be auto, inline or subprocess, not {isolate!r}")

    runs, output_dp = expand_input_files_for_experiments(input_dp, output_dp)
    for run_dp in runs:
        run_dp = run_dp.rstrip("/")
        run_name = os.path.basename(run_dp)
        mode = isolate
        if mode == "auto":
            mode = "subprocess" if _scene_is_large(run_dp) else "inline"
        if mode == "subprocess":
            logger.info("EvalAll", f"{run_name}: fresh-worker mode "
                                   f"(batch_images={batch_images or 'whole split'}, "
                                   f"stall timeout {stall_timeout_s:.0f}s)")
            for split in splits:
                _run_split_isolated(run_dp, output_dp, split, epoch, chunk, batch_images,
                                    stall_timeout_s, device=dev)
            continue
        pipeline, params, rcfg, step = load_run(run_dp, epoch, device=dev)
        for split in splits:
            logger.info("EvalAll", f"{run_name} [{split}]")
            _eval_split(pipeline, params, rcfg, step, run_dp, output_dp, split, chunk=chunk,
                        device=dev)
    gather(output_dp, os.path.join(output_dp, "gathered.txt"))


def main(argv=None):
    from satnerf_torch.eval.eval_nerf import _parse

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    args, kwargs = _parse(argv)
    if kwargs.pop("worker", False):
        return _worker(os.path.abspath(args[0]), os.path.abspath(args[1]), kwargs["split"],
                       epoch=kwargs.get("epoch", -1), chunk=kwargs.get("chunk", 16384),
                       max_images=kwargs.get("batch_images", 0), device=kwargs.get("device"))
    eval_all(*args, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
