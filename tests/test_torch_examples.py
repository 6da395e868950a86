"""The port's examples stay runnable: each runs end to end as a user runs it
(``python -m satnerf_torch.examples.<name> --device cpu``, in a subprocess)
at a tiny size (``SATNERF_EXAMPLES_STEPS`` / ``SATNERF_EXAMPLES_IMG``), as
``tests/test_examples.py`` runs the JAX package's: 01 trains, 02 writes the
battery's results.json files and prints the gathered table, 03 writes three
PNGs that decode to the served views, 04's checkpoint round trip is exact.
Also: without ``--device cpu`` an example asks for the card and raises.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def example_env(tmp_path_factory):
    env = dict(os.environ)
    env.update(
        SATNERF_EXAMPLES_OUT=str(tmp_path_factory.mktemp("examples_ws")),
        SATNERF_EXAMPLES_STEPS="6",
        SATNERF_EXAMPLES_IMG="24",
    )
    return env


def _run(name: str, env, device: str | None = "cpu") -> subprocess.CompletedProcess:
    argv = [sys.executable, "-m", f"satnerf_torch.examples.{name}"]
    if device:
        argv += ["--device", device]
    return subprocess.run(argv, env=env, capture_output=True, text=True, timeout=600,
                          cwd=REPO)


def _ok(name: str, env) -> str:
    proc = _run(name, env)
    assert proc.returncode == 0, f"{name} failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def test_01_train(example_env):
    out = _ok("01_train_synthetic", example_env)
    assert "trained run:" in out
    run_dp = out.split("trained run:")[1].split()[0]
    assert os.path.isfile(os.path.join(run_dp, "ckpoints", "last.ckpt"))


def test_02_eval_battery(example_env):
    out = _ok("02_eval_battery", example_env)
    assert "results under:" in out
    assert "PSNR" in out  # the gathered table
    ws = example_env["SATNERF_EXAMPLES_OUT"]
    results = glob.glob(os.path.join(ws, "evalout", "*", "*", "test", "results.json"))
    assert {os.path.basename(os.path.dirname(os.path.dirname(r))) for r in results} == {
        "eval", "eval_semantic"}
    for fp in results:
        with open(fp) as f:
            assert json.load(f)


def test_03_relight(example_env):
    from satnerf_torch.io.png import load_png

    out = _ok("03_relight_views", example_env)
    assert out.count("wrote") == 3
    pngs = sorted(glob.glob(os.path.join(example_env["SATNERF_EXAMPLES_OUT"], "relight",
                                         "*.png")))
    assert [os.path.basename(p).rsplit("_", 1)[1] for p in pngs] == [
        "dusk.png", "noon.png", "ts1.png"]
    imgs = [load_png(p) for p in pngs]
    assert all(im.shape == (24, 24, 3) and im.dtype.name == "uint8" for im in imgs)
    assert not (imgs[0] == imgs[1]).all()  # dusk is not noon


def test_04_interop(example_env):
    out = _ok("04_reference_interop", example_env)
    assert "round trip exact" in out
    fp = os.path.join(example_env["SATNERF_EXAMPLES_OUT"], "exported_reference.ckpt")
    state = torch.load(fp, weights_only=True)["state_dict"]
    assert "model_coarse.fc_net.0.weight" in state and "model_t.weight" in state


def test_examples_refuse_the_cpu_unasked(example_env):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = _run("01_train_synthetic", example_env, device=None)
    assert proc.returncode != 0 and "CUDA device requested" in proc.stderr
