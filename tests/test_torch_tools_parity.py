"""The port's quality tools against the JAX package's, on the CPU.

* ``evaluate_ours``: one scene made by the JAX package's ``generate_scene``
  and read by both packages' pipelines; the JAX pipeline's parameters at
  seed 0 carried into the port by ``params_from_jax``; the JAX tool's
  ``evaluate_ours`` (``tools/ours_train_eval.py``) and the port's give the
  same PSNR within 0.01 dB, SSIM and DSM MAE within 1e-3, semantic accuracy
  and mIoU within 1e-4, mean and per image (the bars of
  ``tests/test_torch_eval.py``: one unit in the last printed digit).
* ``quality_gate``, ``anchor_table`` and ``time_to_parity`` print the JAX
  tools' tables from the same fixture JSONs; only ``anchor_table``'s side
  labels differ (the port's side is ``satnerf_torch``, the other side the
  JAX package's runs).
* ``ours_train_eval``'s CLI at a tiny size: ``results.json`` and one
  ``results_step<N>.json`` per horizon, every metric finite;
  ``sin_swap_eval`` over that run: a row for each engine, ``exact`` equal to
  the plain field's render of the same checkpoint under ``torch.sin``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARS = {"psnr": 0.01, "ssim": 1e-3, "mae": 1e-3, "acc": 1e-4, "miou": 1e-4}
TINY = dict(n_samples=8, fc_units=32, fc_layers=2, fc_skips=[1])


def _jax_tool(name: str):
    """A module of the JAX package's root ``tools/``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configs(pkg, base, name: str):
    run = pkg.RunConfig(dataset_name="SYN", datasets_dp=str(base / "datasets"),
                        cache_dp=str(base / f"cache_{name}"),
                        workspace_dp=str(base / f"training_{name}"), max_train_steps=8,
                        num_sanity_val_steps=0, seed=0)
    pipe = pkg.RSSemanticConfig(ignore_car_index=False, use_car_reg_loss=True,
                                car_reg_loss_start=3, lambda_c=1.0, **TINY)
    return pkg.MainConfig(run, pipe)


@pytest.fixture(scope="module")
def both_evals(tmp_path_factory):
    """evaluate_ours of both packages on one scene and one set of weights."""
    import jax

    from satnerf_torch import configs as tconfigs
    from satnerf_torch.models.import_params import params_from_jax
    from satnerf_torch.pipelines import load_pipeline as tload_pipeline
    from satnerf_torch.tools.ours_train_eval import evaluate_ours
    from satnerf_tpu import configs as jconfigs
    from satnerf_tpu.datasets.synthetic import generate_scene
    from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
    from satnerf_tpu.train.state import init_params

    base = tmp_path_factory.mktemp("ours_parity")
    generate_scene(str(base / "datasets" / "SYN"), n_train=2, n_test=2, img_size=32,
                   n_tie_points=60)
    jpipe = jload_pipeline(_configs(jconfigs, base, "jax"))
    jpipe.prepare_run()
    jpipe.load_datasets()
    tpipe = tload_pipeline(_configs(tconfigs, base, "torch"))
    tpipe.prepare_run()
    tpipe.load_datasets()

    jfcfg = jpipe.step_config(1).render.field
    jparams = init_params(jax.random.PRNGKey(0), jfcfg, jpipe.t_vocab)
    tfcfg = tpipe.step_config(1, device="cpu").render.field
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tfcfg, device="cpu")

    ours_jax = _jax_tool("ours_train_eval")
    jres = ours_jax.evaluate_ours(types.SimpleNamespace(out_dp=str(base / "dsm_jax")), jpipe,
                                  types.SimpleNamespace(params=jparams))
    tres = evaluate_ours(types.SimpleNamespace(out_dp=str(base / "dsm_torch")), tpipe,
                         types.SimpleNamespace(params=tparams))
    return jres, tres


@pytest.mark.parametrize("key", list(BARS))
def test_evaluate_ours_matches_the_jax_tool(both_evals, key):
    jres, tres = both_evals
    assert set(tres) == set(jres)
    assert math.isfinite(tres[key])
    assert abs(tres[key] - jres[key]) <= BARS[key], (key, tres[key], jres[key])
    assert set(tres["per_image"]) == set(jres["per_image"]) and len(tres["per_image"]) == 2
    for name, want in jres["per_image"].items():
        if key in want:
            got = tres["per_image"][name][key]
            assert abs(got - want[key]) <= BARS[key], (name, key, got, want[key])


def _write(fp, obj) -> None:
    os.makedirs(os.path.dirname(fp), exist_ok=True)
    with open(fp, "w") as f:
        json.dump(obj, f)


def _metrics(rng, step=None, secs=None) -> dict:
    r = {"psnr": float(rng.uniform(20, 32)), "ssim": float(rng.uniform(0.6, 0.96)),
         "mae": float(rng.uniform(1.2, 4.0)), "acc": float(rng.uniform(0.7, 0.99)),
         "miou": float(rng.uniform(0.1, 0.7)), "per_image": {"v": {"psnr": 1.0}}}
    if step is not None:
        r["steps"] = step
    if secs is not None:
        r["train_seconds_to_here"] = secs
    return r


@pytest.fixture(scope="module")
def fixture_jsons(tmp_path_factory):
    """Results JSONs in the three tools' layouts, from one seeded stream."""
    root = tmp_path_factory.mktemp("tables")
    rng = np.random.default_rng(0)
    for eng in ("poly", "poly5", "poly7f"):
        for seed in (0, 1):
            _write(str(root / "gate" / f"{eng}_s{seed}" / "results.json"), _metrics(rng))
    for run in ("ours_s0", "ours_s1", "ref_s0", "ref_s1"):
        for step in (1000, 2000):
            _write(str(root / "anchor" / run / f"results_step{step}.json"), _metrics(rng))
        _write(str(root / "anchor" / run / "results.json"), _metrics(rng, 3000))
    curves = []
    for i, run in enumerate(("curve_a", "curve_b", "curve_c")):
        for step in (500, 1000, 2000):
            r = _metrics(rng, secs=60.0 * step / 500 + i)
            if i == 0 and step >= 1000:  # crosses the thresholds at 1,000
                r.update(psnr=27.0, miou=0.2, acc=0.85, mae=1.3)
            _write(str(root / "ttp" / run / f"results_step{step}.json"), r)
        curves.append(str(root / "ttp" / run))
    _write(str(root / "ttp" / "curve_b" / "results.json"),
           dict(_metrics(rng, 2000), psnr=30.0, miou=0.3, acc=0.9, mae=1.0))
    return {
        "quality_gate": [str(root / "gate"), "--engines", "poly,poly5,poly7f", "--seeds",
                         "0,1"],
        "anchor_table": [str(root / "anchor"), "--ours", "ours_s0,ours_s1", "--ref",
                         "ref_s0,ref_s1", "--steps", "1000,2000,3000"],
        "time_to_parity": curves + ["--chips", "4"],
    }


@pytest.mark.parametrize("tool", ["quality_gate", "anchor_table", "time_to_parity"])
def test_table_tools_print_the_jax_tables(fixture_jsons, tool, capsys):
    import importlib

    argv = fixture_jsons[tool]
    port = importlib.import_module(f"satnerf_torch.tools.{tool}")
    assert port.main(list(argv)) == 0
    got = capsys.readouterr().out
    assert _jax_tool(tool).main(list(argv)) == 0
    want = capsys.readouterr().out
    assert got.count("\n") > 3
    if tool == "anchor_table":
        want = want.replace("ours (satnerf_tpu)", "ours (satnerf_torch)").replace(
            "reference (torch)", "reference (satnerf_tpu)")
        assert "ours (satnerf_torch) (n=2)" in got and "reference (satnerf_tpu) (n=2)" in got
    assert got == want


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    """``ours_train_eval`` through its CLI entry at a tiny size, on the CPU."""
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.tools import ours_train_eval

    base = tmp_path_factory.mktemp("ours_cli")
    scene = str(base / "datasets" / "SYN")
    generate_scene(scene, n_train=2, n_test=1, img_size=24, n_tie_points=50)
    out = str(base / "poly_s0")
    rc = ours_train_eval.main([scene, out, "--steps", "12", "--batch", "64", "--units", "32",
                               "--n-samples", "8", "--eval-at", "4,8,99", "--device", "cpu"])
    assert rc == 0
    return out


def test_ours_train_eval_writes_the_results_and_the_horizons(tool_run):
    names = sorted(f for f in os.listdir(tool_run) if f.startswith("results"))
    assert names == ["results.json", "results_step4.json", "results_step8.json"]
    for name in names:
        with open(os.path.join(tool_run, name)) as f:
            r = json.load(f)
        for k in BARS:
            assert math.isfinite(r[k]), (name, k, r[k])
        assert ("train_seconds_to_here" in r) == (name != "results.json")
    with open(os.path.join(tool_run, "results.json")) as f:
        final = json.load(f)
    assert final["steps"] == 12 and final["it_per_s_wall"] > 0


def test_sin_swap_rows_and_the_exact_engine_is_the_plain_field(tool_run, tmp_path, capsys):
    from satnerf_torch.eval.eval_nerf import evaluate_image
    from satnerf_torch.eval.loader import load_run
    from satnerf_torch.render.renderer import render_image_chunked
    from satnerf_torch.tools import sin_swap_eval

    (run_dp,) = [os.path.join(tool_run, "training", d)
                 for d in os.listdir(os.path.join(tool_run, "training"))]
    sins = ["poly", "poly5", "poly7f", "exact"]
    out = str(tmp_path / "swap")
    assert sin_swap_eval.main([run_dp, "--sins", ",".join(sins), "--out", out,
                               "--device", "cpu"]) == 0
    with open(os.path.join(out, "summary.json")) as f:
        rows = json.load(f)
    assert [r["eval_sin"] for r in rows] == sins
    assert all(r["run"] == "poly_s0" for r in rows)
    assert capsys.readouterr().out.count("SINSWAP ") == 4
    for r in rows:  # on the CPU every engine runs the plain field, one call per chunk
        assert r["field_kernel_launches"] == 0 and r["plain_field_calls"] == 1
        assert all(math.isfinite(r[k]) for k in ("psnr", "ssim", "mae"))

    pipeline, params, rcfg, step = load_run(run_dp, -1, device="cpu")
    exact = dataclasses.replace(rcfg, field=dataclasses.replace(rcfg.field, sin_impl="exact"))
    test = pipeline.datasets["rgb_test"]
    img = test.image_item(1)
    res = render_image_chunked(params, exact, img["rays"], img["extras"], chunk=16384,
                               device="cpu")
    entry = evaluate_image(test, img, res, str(tmp_path / "plain"), step)
    assert rows[-1]["psnr"] == float(entry["psnr"])
    assert rows[-1]["ssim"] == float(entry["ssim"])
    assert rows[-1]["mae"] == float(entry["mae"]["mean"])
