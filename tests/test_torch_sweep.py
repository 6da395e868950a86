"""The port's sweep launcher (``satnerf_torch/run/automated_training.py``)
mirrors ``tests/test_sweep.py``: the experiment TOML gives the JAX
package's dumped configs key for key, ids go round robin to the workers,
the launch script pins each worker to its card, and ``launch`` trains every
experiment in this process (``--device cpu``)."""

from __future__ import annotations

import os

import pytest
import torch

from satnerf_tpu.run import automated_training as jauto
from satnerf_torch.configs import read_toml
from satnerf_torch.datasets.synthetic import generate_scene
from satnerf_torch.run.automated_training import (
    assign_round_robin,
    create_launch_script,
    launch,
    main,
    prepare,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sweep_setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep")
    generate_scene(str(base / "datasets" / "SYN_SWEEP"), n_train=2, n_test=1, img_size=32,
                   n_tie_points=60)
    cfg_dp = base / "cfgs"
    os.makedirs(cfg_dp)
    (cfg_dp / "run.toml").write_text(
        f'max_train_steps = 4\nnum_sanity_val_steps = 0\n'
        f'dataset_name = "SYN_SWEEP"\n'
        f'datasets_dp = "{base / "datasets"}"\n'
        f'cache_dp = "{base / "cache"}"\n'
        f'workspace_dp = "{base / "training"}"\n')
    (cfg_dp / "satnerf.toml").write_text(
        'pipeline = "satnerf"\nn_samples = 4\nfc_layers = 2\nfc_units = 32\n'
        "fc_skips = [1]\nbatch_size = 128\ndepth_enabled = false\n"
        "render_chunk_size = 2048\n")
    (cfg_dp / "experiment.toml").write_text(
        'run_cfg = "run.toml"\n'
        'experiment_category = "demo"\n'
        "[pipeline]\n"
        "n_samples = 4\n"
        "[run]\n"
        "max_train_steps = 4\n"
        "[[experiments]]\n"
        'pipeline_name = "satnerf.toml"\nid = "1a"\n'
        "[experiments.pipeline]\nsc_lambda = 0.0\n"
        "[[experiments]]\n"
        'pipeline_name = "satnerf.toml"\nid = "2a"\n'
        "[experiments.pipeline]\nsc_lambda = 0.05\n")
    return base, str(cfg_dp / "experiment.toml")


def test_prepare_dumps_the_jax_packages_configs(sweep_setup, tmp_path):
    base, exp_fp = sweep_setup
    ids = prepare(exp_fp, str(tmp_path / "port"))
    assert ids == jauto.prepare(exp_fp, str(tmp_path / "jax")) == ["1a", "2a"]
    for exp_id in ids:
        for name in ("run.toml", "pipeline.toml"):
            got = read_toml(str(tmp_path / "port" / exp_id / name))
            want = read_toml(str(tmp_path / "jax" / exp_id / name))
            assert got == want, (exp_id, name)
    p1 = read_toml(str(tmp_path / "port" / "1a" / "pipeline.toml"))
    p2 = read_toml(str(tmp_path / "port" / "2a" / "pipeline.toml"))
    assert p1["sc_lambda"] == 0.0 and p2["sc_lambda"] == 0.05
    r1 = read_toml(str(tmp_path / "port" / "1a" / "run.toml"))
    assert r1["run_name_postfix"].endswith("_exp1a")
    assert "demo" in r1["experiment_category"]


def test_round_robin():
    for ids, workers in ((["a", "b", "c"], 2), (["a"], 4), (["a", "b", "c", "d", "e"], 3)):
        assert assign_round_robin(ids, workers) == jauto.assign_round_robin(ids, workers)
    assert assign_round_robin(["a", "b", "c"], 2) == [["a", "c"], ["b"]]


def test_launch_script_pins_each_worker_to_its_card(sweep_setup, tmp_path):
    base, exp_fp = sweep_setup
    out_dp = str(tmp_path / "out")
    fp = launch(exp_fp, out_dp, workers=2, script_only="true")
    lines = open(fp).read().splitlines()
    assert os.access(fp, os.X_OK)
    workers = [ln for ln in lines if "start_assigned_ids_from_automated" in ln]
    assert workers == [
        f"CUDA_VISIBLE_DEVICES={w} python -m satnerf_torch.run.training "
        f"start_assigned_ids_from_automated {out_dp} {ids} > {out_dp}/worker_{w}.log 2>&1 &"
        for w, ids in ((0, "1a"), (1, "2a"))]
    assert lines[-1] == "wait"
    assert create_launch_script(out_dp, [["1a"], []]) == fp  # empty queues get no line
    assert sum("CUDA_VISIBLE_DEVICES" in ln for ln in open(fp).read().splitlines()) == 1


def test_launch_runs_experiments(sweep_setup, tmp_path):
    base, exp_fp = sweep_setup
    out_dp = str(tmp_path / "out")
    assert main(["launch", exp_fp, out_dp, "--workers", "1", "--device", "cpu"]) == 0
    training_dp = base / "training" / "_demo" / "experiment"
    runs = os.listdir(training_dp)
    assert any("exp1a" in r for r in runs) and any("exp2a" in r for r in runs)
    for r in runs:
        assert os.path.isfile(training_dp / r / "ckpoints" / "last.ckpt")
        assert os.path.isdir(training_dp / r / "visualization" / "test" / "rgb")
