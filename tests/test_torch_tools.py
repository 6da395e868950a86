"""The port's production launcher and four-scene loop on the CPU, at smoke
sizes (as ``tests/test_tools.py`` runs the JAX package's tools): scene
generation, config assembly (the sc_stride and hierarchical variants),
training, ``--resume`` discovery, and the four-scene sweep with its eval
battery and gathered table (a session stopped and resumed bitwise is in
``test_torch_tools_resume.py``). Also: each tool that renders or trains
refuses to run on the CPU unasked, and no tool or example imports JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from satnerf_torch.tools.syn_long_run import main as launcher_main

SMOKE = [
    "--steps", "16", "--batch", "64", "--units", "16",
    "--img-size", "24", "--n-train", "2", "--n-test", "1",
    "--tie-points", "50", "--val-every", "1000", "--device", "cpu",
]


def _run_dirs(out_root):
    ws = os.path.join(out_root, "training")
    return sorted(os.listdir(ws)) if os.path.isdir(ws) else []


def _pipeline_toml(out_root) -> str:
    (run,) = _run_dirs(out_root)
    with open(os.path.join(out_root, "training", run, "configs", "pipeline.toml")) as f:
        return f.read()


def test_launcher_smoke_sc_stride(tmp_path):
    out = str(tmp_path / "run")
    assert launcher_main([out, "--seed", "3", "--sc-stride", "2"] + SMOKE) == 0
    assert os.path.isfile(os.path.join(out, "scene", "root.json"))
    runs = _run_dirs(out)
    assert len(runs) == 1 and "sc2" in runs[0]
    assert "sc_stride = 2" in _pipeline_toml(out)
    ckpt_dp = os.path.join(out, "training", runs[0], "ckpoints")
    assert os.path.isdir(ckpt_dp) and os.listdir(ckpt_dp)
    # --resume discovers the run dir and exits cleanly (its steps are met)
    assert launcher_main([out, "--resume", "--device", "cpu"]) == 0


def test_launcher_resume_without_run_fails(tmp_path):
    out = str(tmp_path / "empty")
    os.makedirs(os.path.join(out, "training"))
    assert launcher_main([out, "--resume", "--device", "cpu"]) == 1


def test_launcher_smoke_hierarchical(tmp_path):
    out = str(tmp_path / "hier")
    assert launcher_main([out, "--seed", "3", "--n-importance", "4",
                          "--use-fine-network"] + SMOKE) == 0
    runs = _run_dirs(out)
    assert len(runs) == 1 and "hier" in runs[0]
    txt = _pipeline_toml(out)
    assert "n_importance = 4" in txt
    assert "use_fine_network = true" in txt
    assert "batch_size = 64" in txt  # the smoke --batch wins over the hier batch drop


def test_four_scenes_workflow_smoke(tmp_path):
    """The reference's primary user loop (one run per area, then one gathered
    table) end to end on two tiny synthetic regimes."""
    from satnerf_torch.tools.four_scenes import main as four_main

    root = str(tmp_path / "four")
    assert four_main([
        root, "--steps", "8", "--img-size", "24", "--n-train", "2",
        "--n-test", "1", "--batch", "64", "--units", "32",
        "--n-samples", "8", "--tie-points", "60",
        "--scenes", "SYN_SUBURB,SYN_RESIDENT", "--device", "cpu",
    ]) == 0
    table_fp = os.path.join(root, "gathered_four_scenes.txt")
    assert os.path.isfile(table_fp)
    with open(table_fp) as f:
        table = f.read()
    assert "SYN_SUBURB" in table and "SYN_RESIDENT" in table
    assert "PSNR" in table and "mIoU" in table


ENTRY_POINTS = {
    "ours_train_eval": ["scene", "out"], "syn_long_run": ["out"],
    "sin_swap_eval": ["run"], "four_scenes": ["out"],
}


@pytest.mark.parametrize("tool", sorted(ENTRY_POINTS))
def test_tools_refuse_the_cpu_unasked(tool, tmp_path, monkeypatch):
    """Without ``--device cpu`` a tool asks for the card and raises before it
    writes anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"satnerf_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mod.main(list(ENTRY_POINTS[tool]))
    assert os.listdir(tmp_path) == []


def test_no_tool_or_example_imports_jax():
    """Every module of ``satnerf_torch.tools`` and ``satnerf_torch.examples``
    imports with jax, the JAX package and the root tools/examples blocked."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'satnerf_tpu', 'flax', 'optax', 'tools', 'examples', "
        "'_common', 'bench', '__graft_entry__'):\n"
        "    sys.modules[name] = None\n"
        "import satnerf_torch.tools as t, satnerf_torch.examples as e\n"
        "mods = [f'{p.__name__}.{m.name}' for p in (t, e) for m in pkgutil.iter_modules(p.__path__)]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == 15  # 10 tools, _common and 4 examples
