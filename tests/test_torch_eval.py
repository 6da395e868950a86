"""The port's eval battery on the CPU, against the JAX package.

``eval_all(isolate="inline", device="cpu")`` over a tiny port run (trained
through the port's CLI, ``torch_parity.train_tiny_run``) against the JAX
package's consumers (``evaluate_image``, ``evaluate_semantic_image``,
``export_image_clouds``, ``_with_running_means``,
``write_semantic_results``) fed the JAX package's renders of the same
images from the same ``best`` checkpoint: every per-image and mean value of
both results.json files agrees to one unit in its last printed digit (PSNR
0.01, SSIM and MAE 0.001, accuracy and mIoU 1e-4), the confusion matrices
within 1e-3, the PLY point counts are equal and the points within 1e-3 m.
Also: the subprocess workers give the inline results.json byte for byte,
a healthy batch boundary uses up no respawn while failures still raise,
the render-view CLI, the study tools, the gathered tables, the
confusion-matrix figure, the eval CLI refusing to run on the CPU unasked,
``ckpt`` naming the checkpoint the battery restores, and ``rung_audit.py``
saving the first test view as ``evaluate_ours`` renders it."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_parity import train_tiny_run

from satnerf_torch.eval import eval as eval_mod
from satnerf_torch.eval.extract_pointcloud import read_ply
from satnerf_torch.eval.semantic_metrics import blues, render_confusion_matrix_png
from satnerf_torch.io.png import load_png

CHUNK = 2048
SPLITS = ("train", "test")
# one unit in the last printed digit of each results.json value
BARS = {"psnr": 0.01, "ssim": 1e-3, "mae": 1e-3, "MAE": 1e-3,
        "PSNR": 0.01, "SSIM": 1e-3, "semantic": 1e-4, "Semantic": 1e-4, "mIoU": 1e-4,
        "uncertainty": 1e-4, "Uncertainty": 1e-4, "per_class_iou": 1e-4,
        "confusion_matrix": 1e-3}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_battery")
    pipeline, _ = train_tiny_run(base)
    run_dp = pipeline.cfg.run.run_dp
    out = str(base / "inline")
    eval_mod.eval_all(run_dp, out, splits=",".join(SPLITS), chunk=CHUNK, isolate="inline",
                      device="cpu")
    return {"base": base, "run_dp": run_dp, "out": out, "name": os.path.basename(run_dp)}


@pytest.fixture(scope="module")
def jax_battery(run):
    """The JAX package's consumers on its own renders of every image, into
    the same layout as eval_all's."""
    from satnerf_tpu import configs as jconfigs
    from satnerf_tpu.eval.eval_nerf import _with_running_means, evaluate_image
    from satnerf_tpu.eval.eval_semantic import evaluate_semantic_image, write_semantic_results
    from satnerf_tpu.eval.extract_pointcloud import export_image_clouds
    from satnerf_tpu.models.import_torch import params_from_lightning_ckpt
    from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
    from satnerf_tpu.render.renderer import render_image_chunked as jrender

    run_dp = run["run_dp"]
    jpipe = jload_pipeline(jconfigs.load_configs_from_logs(run_dp))
    jpipe.load_datasets()
    jrcfg = dataclasses.replace(jpipe.step_config(steps_per_epoch=1, with_depth=False).render,
                                solar_correction=False)
    best = os.path.join(run_dp, "ckpoints", "best.ckpt")
    jparams = params_from_lightning_ckpt(best, jrcfg.field, t_vocab=50)
    step = int(torch.load(best, weights_only=True)["step"])
    root = os.path.join(str(run["base"]), "jax", run["name"])
    renders = {}  # by view: the test split starts with the first train view
    for split in SPLITS:
        dataset = jpipe.datasets["rgb" if split == "train" else "rgb_test"]
        dps = {k: os.path.join(root, k, split) for k in ("eval", "eval_semantic", "pointclouds")}
        for dp in dps.values():
            os.makedirs(dp, exist_ok=True)
        nerf, sem = {}, {}
        cm = np.zeros((5, 5))
        for i in range(len(dataset.data)):
            img = dataset.image_item(i)
            if img["name"] not in renders:
                renders[img["name"]] = {k: np.asarray(v) for k, v in jrender(
                    jparams, jrcfg, img["rays"], img["extras"], chunk=CHUNK).items()}
            res = renders[img["name"]]
            export_image_clouds(dataset, img, res, dps["pointclouds"], step)
            if split == "test" and i == 0:
                continue  # the prepended train view
            nerf[img["name"]] = evaluate_image(dataset, img, res, dps["eval"], step)
            sem[img["name"]], cm_raw = evaluate_semantic_image(dataset, img, res,
                                                               dps["eval_semantic"], False)
            cm += cm_raw
        with open(os.path.join(dps["eval"], "results.json"), "w") as f:
            json.dump(_with_running_means(nerf), f, indent=4)
        write_semantic_results(sem, cm, list(dataset.semantic_cls_labels.values()),
                               dps["eval_semantic"])
    return root


def _bar(path: str) -> float:
    for key, bar in BARS.items():
        if key in path:
            return bar
    raise KeyError(f"no bar for {path}")


def _compare(got, want, path: str = ""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _compare(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        g, w = float(got), float(want)
        assert np.isfinite(g) and np.isfinite(w), (path, got, want)
        # strings printed to a digit may round a hair's difference either way
        assert abs(g - w) <= _bar(path) * (1 + 1e-6), (path, got, want)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kind", ["eval", "eval_semantic"])
def test_results_match_the_jax_package(run, jax_battery, split, kind):
    with open(os.path.join(run["out"], run["name"], kind, split, "results.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_battery, kind, split, "results.json")) as f:
        want = json.load(f)
    assert len(got) == len(want) > 1
    _compare(got, want)


@pytest.mark.parametrize("split", SPLITS)
def test_point_clouds_match_the_jax_package(run, jax_battery, split):
    got_dp = os.path.join(run["out"], run["name"], "pointclouds", split)
    want_dp = os.path.join(jax_battery, "pointclouds", split)
    names = sorted(os.listdir(want_dp))
    assert sorted(os.listdir(got_dp)) == names and len(names) == 4 * 2  # 4 clouds per image
    for fn in names:
        got, want = read_ply(os.path.join(got_dp, fn)), read_ply(os.path.join(want_dp, fn))
        assert got.shape == want.shape, fn
        if "filtered" not in fn:
            assert got.shape[0] == 40 * 40  # one point per ray
        for c in ("x", "y", "z"):
            assert float(np.abs(got[c] - want[c]).max()) <= 1e-3, (fn, c)
        for c in ("nx", "ny", "nz"):
            np.testing.assert_array_equal(got[c], want[c])
        for c in ("red", "green", "blue"):  # 8-bit colours of rgb within 5e-5
            assert int(np.abs(got[c].astype(int) - want[c].astype(int)).max()) <= 1, (fn, c)


def test_battery_layout_partials_and_tables(run):
    from satnerf_tpu.eval.gather_eval import gather as jgather

    from satnerf_torch.eval.gather_eval import gather

    root = os.path.join(run["out"], run["name"])
    for split, n in (("train", 2), ("test", 2)):
        partial_dp = os.path.join(root, "partial", split)
        parts = [f for f in os.listdir(partial_dp) if f.endswith(".json")]
        assert len(parts) == n and os.path.isfile(os.path.join(partial_dp, ".heartbeat"))
        for fn in parts:
            with open(os.path.join(partial_dp, fn)) as f:
                seconds = json.load(f)["seconds"]
            assert {"render", "clouds"} <= set(seconds)
            assert all(v >= 0 for v in seconds.values())
        sem_dp = os.path.join(root, "eval_semantic", split)
        assert load_png(os.path.join(sem_dp, "mean.png")).shape == (160, 160, 3)
    with open(os.path.join(run["out"], "gathered.txt")) as f:
        gathered = f.read()
    assert gathered == gather(run["out"]) == jgather(run["out"])
    assert "PSNR" in gathered and "tabular" in gathered


def test_subprocess_workers_give_the_inline_results_byte_for_byte(run, tmp_path):
    out = str(tmp_path / "workers")
    eval_mod.eval_all(run["run_dp"], out, splits="test", chunk=CHUNK, isolate="subprocess",
                      batch_images=1, stall_timeout_s=600.0, device="cpu")
    for kind in ("eval", "eval_semantic"):
        fps = [os.path.join(d, run["name"], kind, "test", "results.json") for d in (out, run["out"])]
        got, want = (open(fp).read() for fp in fps)
        assert got == want, kind
    assert os.path.isfile(os.path.join(out, "gathered.txt"))


def test_ckpt_names_the_checkpoint_the_battery_restores(run, tmp_path):
    from satnerf_torch.eval.loader import load_run
    from satnerf_torch.train.checkpoint import find_ckpoint_fp

    steps = {name: torch.load(os.path.join(run["run_dp"], "ckpoints", f"{name}.ckpt"),
                              weights_only=True)["step"] for name in ("best", "last")}
    assert load_run(run["run_dp"], ckpt="last", device="cpu")[3] == steps["last"]
    with pytest.raises(FileNotFoundError, match="epoch_99"):
        find_ckpoint_fp(run["run_dp"], name="epoch_99")
    for name, isolate in (("last", "inline"), ("best", "subprocess")):
        out = str(tmp_path / name)
        eval_mod.eval_all(run["run_dp"], out, splits="test", chunk=CHUNK, isolate=isolate,
                          device="cpu", ckpt=name)
        partial_dp = os.path.join(out, run["name"], "partial", "test")
        for fn in (f for f in os.listdir(partial_dp) if f.endswith(".json")):
            with open(os.path.join(partial_dp, fn)) as f:
                assert json.load(f)["step"] == steps[name], (name, fn)
    # best is what the battery restores unasked
    fps = [os.path.join(d, run["name"], "eval", "test", "results.json")
           for d in (str(tmp_path / "best"), run["out"])]
    got, want = (open(fp).read() for fp in fps)
    assert got == want


def test_rung_audit_saves_the_first_test_view_as_evaluate_ours_renders_it(run, tmp_path):
    import importlib.util

    from satnerf_torch.eval.loader import load_run
    from satnerf_torch.render.renderer import render_image_chunked

    spec = importlib.util.spec_from_file_location(
        "rung_audit", os.path.join(os.path.dirname(os.path.dirname(__file__)), "rung_audit.py"))
    rung_audit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rung_audit)
    pipeline, params, rcfg, step = load_run(run["run_dp"], device="cpu")
    fp = str(tmp_path / "render.npz")
    rung_audit._save_render(pipeline, params, fp, step)
    saved = np.load(fp)
    img = pipeline.datasets["rgb_test"].image_item(1)
    want = render_image_chunked(params, rcfg, img["rays"], img["extras"], chunk=8192,
                                device="cpu")
    assert str(saved["name"]) == img["name"] and int(saved["step"]) == step
    for key in rung_audit.RENDER_KEYS:
        np.testing.assert_array_equal(saved[key], want[key])
    beta = (want["weights"][..., None] * want["beta"]).sum(axis=-2)[:, 0]
    np.testing.assert_array_equal(saved["beta_composited"], beta)


def _fake_workers(monkeypatch, codes):
    """Replace the worker command: the n-th spawn exits with codes[n]."""
    calls = []
    real_popen = eval_mod.subprocess.Popen

    def fake_popen(cmd, **kw):
        calls.append(cmd)
        rc = codes[min(len(calls), len(codes)) - 1]
        return real_popen([sys.executable, "-c", f"import sys; sys.exit({rc})"])

    monkeypatch.setattr(eval_mod.subprocess, "Popen", fake_popen)
    return calls


def test_batch_boundaries_use_up_no_respawn(run, tmp_path, monkeypatch):
    """Five healthy EXIT_MORE_REMAIN exits then a complete one finish with
    max_respawns=1; the workers receive the device and their batch size."""
    more = eval_mod.EXIT_MORE_REMAIN
    calls = _fake_workers(monkeypatch, [more] * 5 + [0])
    eval_mod._run_split_isolated(run["run_dp"], str(tmp_path), "test", -1, CHUNK, 1,
                                 stall_timeout_s=60.0, max_respawns=1, device="cpu")
    assert len(calls) == 6
    cmd = calls[0]
    assert cmd[cmd.index("--device") + 1] == "cpu" and cmd[cmd.index("--batch-images") + 1] == "1"


@pytest.mark.parametrize("max_respawns", [25, 1])
def test_worker_failures_still_raise(run, tmp_path, monkeypatch, max_respawns):
    more = eval_mod.EXIT_MORE_REMAIN
    calls = _fake_workers(monkeypatch, [more, 1, more, 1, 1, 0])
    with pytest.raises(RuntimeError, match="failed or stalled"):
        eval_mod._run_split_isolated(run["run_dp"], str(tmp_path), "test", -1, CHUNK, 1,
                                     stall_timeout_s=60.0, max_respawns=max_respawns,
                                     device="cpu")
    # three failures with the defaults; the second failure past max_respawns=1
    assert len(calls) == (5 if max_respawns == 25 else 4)


def test_a_stalled_worker_is_terminated_and_respawned(run, tmp_path, monkeypatch):
    calls = []
    real_popen = eval_mod.subprocess.Popen

    def fake_popen(cmd, **kw):
        calls.append(cmd)
        code = "import time; time.sleep(600)" if len(calls) == 1 else "import sys; sys.exit(0)"
        return real_popen([sys.executable, "-c", code])

    monkeypatch.setattr(eval_mod.subprocess, "Popen", fake_popen)
    eval_mod._run_split_isolated(run["run_dp"], str(tmp_path), "test", -1, CHUNK, 0,
                                 stall_timeout_s=1.0, device="cpu")
    assert len(calls) == 2


def test_partials_resume_and_stale_steps_rerender(run, tmp_path, monkeypatch):
    from satnerf_torch.eval.loader import load_run

    pipeline, params, rcfg, step = load_run(run["run_dp"], device="cpu")
    rendered = []
    real = eval_mod.render_image_chunked

    def counting(params, rcfg, rays, extras, chunk=16384, device=None):
        rendered.append(rays.shape[0])
        return real(params, rcfg, rays, extras, chunk=chunk, device=device)

    monkeypatch.setattr(eval_mod, "render_image_chunked", counting)
    out = str(tmp_path)
    args = (pipeline, params, rcfg, step, run["run_dp"], out, "test")
    assert not eval_mod._eval_split(*args, chunk=CHUNK, max_images=1, device="cpu")
    assert eval_mod._eval_split(*args, chunk=CHUNK, device="cpu") and len(rendered) == 2
    rendered.clear()
    stale = (pipeline, params, rcfg, step + 1, run["run_dp"], out, "test")
    assert eval_mod._eval_split(*stale, chunk=CHUNK, device="cpu") and len(rendered) == 2


def test_render_view_cli_writes_the_served_view(run, tmp_path):
    from satnerf_torch.eval import render_view
    from satnerf_torch.serve.service import RenderService

    out = str(tmp_path / "views")
    name = "SYN_001_001_RGB"
    render_view.main([run["run_dp"], name, "--out", out, "--sun_elevation", "25",
                      "--sun_azimuth", "300", "--ts", "1", "--chunk", str(CHUNK),
                      "--device", "cpu", "--save_tif", "true"])
    files = sorted(os.listdir(out))
    assert any("sun25-300_ts1" in f for f in files) and any(f.endswith(".tif") for f in files)
    svc = RenderService.from_run(run["run_dp"], chunk=CHUNK, device="cpu")
    served = svc.render(name, sun_elevation=25.0, sun_azimuth=300.0, ts=1)
    rgb = load_png(os.path.join(out, [f for f in files if f.endswith("_rgb.png")][0]))
    np.testing.assert_array_equal(rgb, (np.clip(served["rgb"], 0, 1) * 255).astype(np.uint8))
    sem = load_png(os.path.join(out, [f for f in files if f.endswith("_semantic.png")][0]))
    np.testing.assert_array_equal(sem, served["semantic_rgb"])
    shaded = [f for f in files if f.endswith("_semantic_shaded.png")][0]
    np.testing.assert_array_equal(load_png(os.path.join(out, shaded)),
                                  served["semantic_shaded_rgb"])
    assert load_png(os.path.join(out, [f for f in files if f.endswith("_depth.png")][0])).shape \
        == (40, 40, 3)


def test_study_tools_match_the_jax_package(run, tmp_path):
    from PIL import Image
    from satnerf_tpu.eval.study import main as jmain

    from satnerf_torch.eval.study import main

    dsm_fp = os.path.join(str(run["base"]), "datasets", "SYN", "SYN_001_DSM.tif")
    for tool, ext in (("tif2png", ".png"), ("dsm2ply", ".ply")):
        main([tool, dsm_fp, str(tmp_path / ("port" + ext))])
        jmain([tool, dsm_fp, str(tmp_path / ("jax" + ext))])
    np.testing.assert_array_equal(load_png(str(tmp_path / "port.png")),
                                  np.asarray(Image.open(str(tmp_path / "jax.png"))))
    got, want = read_ply(str(tmp_path / "port.ply")), read_ply(str(tmp_path / "jax.ply"))
    assert got.shape == want.shape and got.shape[0] > 0
    assert got.tobytes() == want.tobytes()


def test_confusion_matrix_figure_is_the_blues_ramp():
    from matplotlib import cm as mcm

    x = np.linspace(0.0, 1.0, 4097)
    assert int(np.abs(blues(x).astype(int) - mcm.Blues(x, bytes=True)[:, :3]).max()) <= 1
    cmat = np.array([[0.9, 0.1], [0.25, 0.75]])
    fig = render_confusion_matrix_png(cmat, ["a", "b"])
    assert fig.shape == (3, 64, 64) and fig.dtype == np.uint8
    np.testing.assert_array_equal(fig[:, 40, 10], blues(0.25))  # row 1 (true b), column 0
    with pytest.raises(ValueError):
        render_confusion_matrix_png(cmat, ["a"])


def test_eval_cli_without_a_gpu_raises_instead_of_running_on_the_cpu(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = str(tmp_path / "no_gpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_mod.main([run["run_dp"], out])
    assert not os.path.exists(out)


def test_a_typo_path_fails_before_any_output(tmp_path):
    bad = str(tmp_path / "no_such_run")
    with pytest.raises(FileNotFoundError):
        eval_mod.eval_all(bad, splits="test", device="cpu")
    assert not os.path.exists(os.path.join(bad, "eval_battery"))
