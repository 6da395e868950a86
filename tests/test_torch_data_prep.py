"""The port's dataset construction (``satnerf_torch/data_prep``) against the
JAX package's on the same raw DFC2019 Track-3 distribution
(``tests/torch_dfc_case.py``, written from a generated scene): its
dataclass configs against the pydantic ones, the output tree after every
step of every pipeline (the same files; equal JSON, TIFF arrays and
profiles, npy arrays and text, the BA's absolute image paths read relative
to each output), the BA modes that run without sat-bundleadjust (``dsm``,
``native``, ``precomputed``) and how ``external`` and ``auto`` fail or
fall back, each split mode, a pipeline with ``step_cropping`` and masks on
the cropped grid, the lazy re-run, the CLI, the datasets read from the
prepared directory, and a few training steps on it. Both packages run the
same float64 numpy code, so every bar is exact equality."""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dfc_case as dfc
from satnerf_torch.data_prep import create_dataset as tcreate
from satnerf_torch.data_prep import dataset_config as tconf
from satnerf_torch.io.json_io import read_json, write_json
from satnerf_torch.io.tiff import read_geotiff
from satnerf_tpu.data_prep import create_dataset as jcreate
from satnerf_tpu.data_prep import dataset_config as jconf

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dist4(tmp_path_factory):
    """4 views of 96² (enough texture for the native BA's tracks)."""
    return dfc.write_distribution(str(tmp_path_factory.mktemp("dfc4")), 4, 96,
                                  n_tie_points=120)


@pytest.fixture(scope="module")
def dist14(tmp_path_factory):
    """14 views (000-013) of 32², so the predefined SatNeRF test files of
    JAX_068 (002, 012) are among them."""
    return dfc.write_distribution(str(tmp_path_factory.mktemp("dfc14")), 14, 32,
                                  n_tie_points=60)


# ---------------------------------------------------------------------------
# DatasetConfig against pydantic
# ---------------------------------------------------------------------------


def _build(mod, general=None, steps=None):
    try:
        kw = {}
        if general is not None:
            kw["general"] = mod.GeneralConfig(**general)
        if steps is not None:
            kw["steps"] = [mod.StepConfig(**s) for s in steps]
        cfg = mod.DatasetConfig(**kw)
    except ValueError:  # pydantic's ValidationError is a ValueError
        return "raises"
    d = cfg.model_dump() if hasattr(cfg, "model_dump") else dataclasses.asdict(cfg)
    return d


CONFIG_CASES = {
    "defaults": (None, None),
    "test_data_prep": (dict(aoi_name="JAX_068", lazy=True, dfc_rgb_dp="r", dfc_truth_dp="t",
                            dfc_metadata_dp="m", semantic_masks_dp="k", output_dp="o",
                            zone_string="17R", split_mode="fixed", n_test=1),
                       [dict(file="adapter_dfc2019"),
                        dict(file="step_bundle_adjustment", params={"n_points": 200}),
                        dict(file="step_finish_meta_extraction"),
                        dict(file="step_create_root_file"), dict(file="step_semantic")]),
    "test_ba_native": (dict(aoi_name="JAX_068", dfc_rgb_dp="r", dfc_truth_dp="t",
                            dfc_metadata_dp="m", output_dp="o", zone_string="17R",
                            split_mode="fixed", n_test=1),
                       [dict(file="adapter_dfc2019"),
                        dict(file="step_bundle_adjustment", params={"mode": "native"}),
                        dict(file="step_create_root_file")]),
    "numbers_as_strings": (dict(n_test="2", seed=" 7 ", alt_min="-3.5", alt_max="1_0.5"),
                           None),
    "whole_floats_and_bool_forms": (dict(n_test=3.0, lazy="true", seed=True), [
        dict(file="a", enabled="off"), dict(file="b", enabled=1), dict(file="c", enabled="Y"),
        dict(file="d", enabled=0.0)]),
    "optional_none": (dict(ignore_masks_dp=None, semantic_masks_dp=None, alt_min=None), None),
    "sequences": (dict(custom_test_files=("JAX_068_001_RGB", "JAX_068_003_RGB")),
                  [dict(file="x", from_dir="d", params={"mode": "dsm", "n_points": "9"})]),
    "rejects_non_ascii_digits": (dict(alt_min="\u0663"), None),
    "unknown_keys": (dict(not_a_field=1, n_test=4), [dict(file="x", junk=[1, 2])]),
    "rejects_abc": (dict(n_test="abc"), None),
    "rejects_fraction": (dict(n_test=2.5), None),
    "rejects_int_as_str": (dict(aoi_name=68), None),
    "rejects_bool_2": (dict(lazy=2), None),
    "rejects_padded_bool": (dict(lazy=" true"), None),
    "rejects_str_as_list": (dict(custom_test_files="JAX_068_001_RGB"), None),
    "rejects_none": (dict(n_test=None), None),
    "rejects_missing_file": (None, [dict(enabled=True)]),
    "rejects_params_list": (None, [dict(file="x", params=[("a", 1)])]),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_dataset_config_equals_pydantic(case):
    general, steps = CONFIG_CASES[case]
    want = _build(jconf, general, steps)
    assert _build(tconf, general, steps) == want
    assert (want == "raises") == case.startswith("rejects_")


def test_dataset_config_defaults_are_fresh_per_instance():
    a, b = tconf.GeneralConfig(), tconf.GeneralConfig()
    a.custom_test_files.append("x")
    assert b.custom_test_files == [] and tconf.GeneralConfig().custom_test_files == []
    s, t = tconf.StepConfig(file="a"), tconf.StepConfig(file="b")
    s.params["mode"] = "native"
    assert t.params == {}
    assert tconf.DatasetConfig().general is not tconf.DatasetConfig().general
    given = {"mode": "dsm"}
    assert tconf.StepConfig(file="a", params=given).params is not given  # as pydantic copies


@pytest.mark.parametrize("toml", ["template", "prep_steps"])
def test_load_dataset_config_equals_pydantic(toml, tmp_path, dist4):
    if toml == "template":
        fp = os.path.join(REPO, "satnerf_torch", "data_prep", "dataset_template.toml")
    else:
        fp = dfc.write_config(str(tmp_path / "cfg.toml"),
                              dfc.general(dist4, "out", "masks", n_test="1"), dfc.PREP_STEPS)
    assert dataclasses.asdict(tconf.load_dataset_config(fp)) == \
        jconf.load_dataset_config(fp).model_dump()


def test_template_is_the_jax_packages_but_the_name():
    port = open(os.path.join(REPO, "satnerf_torch", "data_prep", "dataset_template.toml"))
    jax_ = open(os.path.join(REPO, "satnerf_tpu", "data_prep", "dataset_template.toml"))
    assert port.read().replace("satnerf_torch", "satnerf_tpu") == jax_.read()


# ---------------------------------------------------------------------------
# the output trees, step by step
# ---------------------------------------------------------------------------


def _norm(x, root: str):
    """JSON-like ``x`` with the output root written as "<out>"."""
    if isinstance(x, str):
        return x.replace(root, "<out>")
    if isinstance(x, dict):
        return {k: _norm(v, root) for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(v, root) for v in x]
    return x


def _profile(p) -> str:
    """A GeoProfile as text (a NaN nodata equals itself)."""
    return repr({**vars(p), "rpc": None if p.rpc is None else p.rpc.to_dict()})


def assert_same_tree(port_dp: str, jax_dp: str):
    files = [sorted(os.path.relpath(os.path.join(d, f), top) for d, _, fs in os.walk(top)
                    for f in fs) for top in (port_dp, jax_dp)]
    assert files[0] == files[1]
    for rel in files[0]:
        a, b = os.path.join(port_dp, rel), os.path.join(jax_dp, rel)
        if rel.endswith(".json"):
            assert _norm(read_json(a), port_dp) == _norm(read_json(b), jax_dp), rel
        elif rel.endswith(".tif"):
            (ta, tp), (ja, jp) = read_geotiff(a), read_geotiff(b)
            assert ta.dtype == ja.dtype, rel
            np.testing.assert_array_equal(ta, ja, err_msg=rel)
            assert _profile(tp) == _profile(jp), rel
        elif rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype, rel
            np.testing.assert_array_equal(x, y, err_msg=rel)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read().replace(port_dp, "<out>") == \
                    fb.read().replace(jax_dp, "<out>"), rel
    return files[0]


def run_both(base, dist, steps, masks_dp=None, **general) -> tuple:
    """Each step through both packages' ``run_processing_step`` with its own
    shared state; after every step the two output trees and states agree.
    -> (port output dir, JAX output dir, port state)."""
    out_t, out_j = str(base / "port" / dist["aoi"]), str(base / "jax" / dist["aoi"])
    cfg_t = tconf.DatasetConfig(general=dfc.general(dist, out_t, masks_dp, **general),
                                steps=steps)
    cfg_j = jconf.DatasetConfig(general=dfc.general(dist, out_j, masks_dp, **general),
                                steps=steps)
    st_t, st_j = {}, {}
    for s_t, s_j in zip(cfg_t.steps, cfg_j.steps):
        tcreate.run_processing_step(s_t, cfg_t, st_t)
        jcreate.run_processing_step(s_j, cfg_j, st_j)
        assert _norm(st_t, out_t) == _norm(st_j, out_j), s_t.file
        assert_same_tree(out_t, out_j)
    return out_t, out_j, st_t


def _record_precomputed(dist, ba_dp: str, flat: bool = False):
    """The sat-bundleadjust output layout from the generated scene's tie
    points and keypoints (PAN paths exercise the reference's rewrites)."""
    syn = dist["syn"]
    if flat:
        os.makedirs(ba_dp, exist_ok=True)
        shutil.copy(os.path.join(syn, "pts3d.npy"), ba_dp)
        return ba_dp
    os.makedirs(os.path.join(ba_dp, "ba_params"), exist_ok=True)
    from satnerf_torch.geo.rpc import RPCModel

    os.makedirs(os.path.join(ba_dp, "rpcs_adj"), exist_ok=True)
    pts2d, cam, ind, paths = [], [], [], []
    for ci, fp in enumerate(sorted(glob.glob(os.path.join(syn, "metas", "*.json")))):
        m = read_json(fp)
        k = m["keypoints"]
        pts2d.append(np.asarray(k["2d_coordinates"], np.float64))
        cam += [ci] * len(k["pts3d_indices"])
        ind += k["pts3d_indices"]
        paths.append(f"/remote/pan_crops/{m['img'].replace('RGB.tif', 'PAN.tif')}")
        RPCModel.from_dict(m["rpc"]).to_rpc_file(
            os.path.join(ba_dp, "rpcs_adj", m["img"][:-4] + ".rpc_adj"))
    bp = os.path.join(ba_dp, "ba_params")
    np.save(os.path.join(bp, "pts3d.npy"), np.load(os.path.join(syn, "pts3d.npy")))
    np.save(os.path.join(bp, "pts2d.npy"), np.concatenate(pts2d))
    np.save(os.path.join(bp, "cam_ind.npy"), np.asarray(cam))
    np.save(os.path.join(bp, "pts_ind.npy"), np.asarray(ind))
    with open(os.path.join(bp, "geotiff_paths.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    return ba_dp


def _ba(mode, **params):
    return {"file": "step_bundle_adjustment", "params": {"mode": mode, **params}}


ADAPTER, CROP, FINISH, ROOT, SEM = ({"file": f} for f in (
    "adapter_dfc2019", "step_cropping", "step_finish_meta_extraction",
    "step_create_root_file", "step_semantic"))

PIPELINES = {
    # the JAX package's own fixture (tests/test_data_prep.py): no cropping
    "dsm_fixed_semantic": ([ADAPTER, _ba("dsm", n_points=200), FINISH, ROOT, SEM],
                           "full", dict(split_mode="fixed", n_test=1)),
    # the Optional fields set: altitude bounds given, an ignore mask copied
    "dsm_alt_bounds_ignore_mask": ([ADAPTER, _ba("auto", n_points=50), ROOT], None,
                                   dict(alt_min=-4.0, alt_max=40.0, split_mode="fixed",
                                        n_test=1, seed=3)),
    "precomputed": ([ADAPTER, _ba("precomputed"), FINISH, ROOT], None,
                    dict(split_mode="random", n_test=1, seed=1)),
    "precomputed_flat": ([ADAPTER, _ba("precomputed"), ROOT], None,
                         dict(split_mode="custom", custom_test_files=["JAX_068_001_RGB"])),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_create_dataset_equals_the_jax_package(name, dist4, tmp_path):
    steps, masks, general = PIPELINES[name]
    steps = [dict(s, params=dict(s.get("params", {}))) for s in steps]
    for s in steps:
        if s["params"].get("mode") == "precomputed":
            s["params"]["precomputed_dp"] = _record_precomputed(
                dist4, str(tmp_path / "ba_out"), flat=name.endswith("flat"))
    if name == "dsm_alt_bounds_ignore_mask":
        os.makedirs(tmp_path / "ignore", exist_ok=True)
        shutil.copy(os.path.join(dist4["truth_dp"], "JAX_068_CLS.tif"),
                    tmp_path / "ignore" / "JAX_068_ignore.tif")
        general = dict(general, ignore_masks_dp=str(tmp_path / "ignore"))
    out_t, _, state = run_both(tmp_path, dist4, steps,
                               dist4["masks_full"] if masks else None, **general)
    root = read_json(os.path.join(out_t, "root.json"))
    assert len(root["train_split"]) + len(root["test_split"]) == 4
    if name == "dsm_alt_bounds_ignore_mask":
        assert root["ignore_mask_fp"] == "JAX_068_ignore.tif"
        assert read_json(os.path.join(out_t, "metas", "JAX_068_000_RGB.json"))["min_alt"] == -4
    if name == "precomputed_flat":
        assert root["test_split"] == ["JAX_068_001_RGB.json"]
    if name == "precomputed":  # the adjusted cameras and keypoints restored
        syn = read_json(os.path.join(dist4["syn"], "metas", "JAX_068_002_RGB.json"))
        meta = read_json(os.path.join(out_t, "metas", "JAX_068_002_RGB.json"))
        assert meta["keypoints"]["pts3d_indices"] == syn["keypoints"]["pts3d_indices"]
    assert state["points3d_fp"] == os.path.join(out_t, "pts3d.npy")


@pytest.mark.parametrize("split_mode", ["predefined", "random", "fixed", "custom"])
def test_split_modes_equal_the_jax_package(split_mode, dist14, tmp_path):
    out_t, _, _ = run_both(tmp_path, dist14, [ADAPTER, _ba("dsm", n_points=100), ROOT],
                           split_mode=split_mode, n_test=3, seed=5,
                           custom_test_files=["JAX_068_004_RGB", "JAX_068_009_RGB"])
    root = read_json(os.path.join(out_t, "root.json"))
    want = {"predefined": ["JAX_068_002_RGB.json", "JAX_068_012_RGB.json"],
            "fixed": [f"JAX_068_0{i}_RGB.json" for i in (11, 12, 13)],
            "custom": ["JAX_068_004_RGB.json", "JAX_068_009_RGB.json"]}
    if split_mode in want:
        assert root["test_split"] == want[split_mode]
    assert len(root["train_split"]) + len(root["test_split"]) == 14


@pytest.fixture(scope="module")
def prepared(dist4, tmp_path_factory):
    """The pipeline the card runs (``PREP_STEPS``: cropping, the native BA,
    masks on the cropped grid), step by step through both packages: first
    up to the cropping step, the masks cut at each crop window, then the
    whole config, whose lazy skip passes over the first two steps."""
    base = tmp_path_factory.mktemp("prepared")
    run_both(base, dist4, dfc.PREP_STEPS[:2])
    windows = dfc.crop_masks(dist4, str(base / "port" / "JAX_068"), str(base / "masks"))
    out_t, out_j, state = run_both(base, dist4, dfc.PREP_STEPS, str(base / "masks"),
                                   split_mode="fixed", n_test=1)
    return {"base": base, "out_t": out_t, "out_j": out_j, "state": state,
            "windows": windows, "dist": dist4}


def test_cropped_pipeline_with_native_ba_equals_the_jax_package(prepared):
    out_t = prepared["out_t"]
    files = assert_same_tree(out_t, prepared["out_j"])
    assert any(f.startswith("images_cropped/") for f in files)
    assert any(f.startswith("semantic_own_no_cars/") for f in files)
    # the crops cut the views: at least one window is smaller than 96²
    assert any((w, h) != (96, 96) for _, _, w, h in prepared["windows"].values())
    root = read_json(os.path.join(out_t, "root.json"))
    assert root["img_dp"] == "images_cropped" and root["points3d_fp"] == "pts3d.npy"
    assert root["semantic_cls_labels"]["4"] == "cars"
    stats = read_json(os.path.join(out_t, "ba_native", "ba_stats.json"))
    assert stats["n_tracks"] >= 10 and stats["mean_reproj_px"] < 1.0
    for name, (_, _, w, h) in prepared["windows"].items():
        cls, prof = read_geotiff(os.path.join(out_t, "semantic_own",
                                              name.replace("_RGB", "_CLS") + ".tif"))
        assert cls.shape == (1, h, w) and (prof.width, prof.height) == (w, h)
        meta = read_json(os.path.join(out_t, "metas", name + ".json"))
        assert len(meta["keypoints"]["2d_coordinates"]) > 0 and "geojson" in meta


def test_full_grid_masks_fail_after_cropping_in_both_packages(prepared, tmp_path):
    """The trap the JAX package's tests never meet: masks annotated on the
    uncropped grid do not fit the cropped images."""
    dist = prepared["dist"]
    errors = []
    for create, conf in ((tcreate, tconf), (jcreate, jconf)):
        out = str(tmp_path / create.__name__.split(".")[0])
        cfg = conf.DatasetConfig(general=dfc.general(dist, out, dist["masks_full"]),
                                 steps=[ADAPTER, CROP, SEM])
        with pytest.raises(AssertionError) as exc:
            create.create_dataset(cfg)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "does not match image" in errors[0]


def test_lazy_rerun_skips_every_step(prepared, monkeypatch):
    import importlib

    ran = []
    for name in tcreate.STEP_REGISTRY.values():
        step_cls = importlib.import_module(name).ProcessingStep
        monkeypatch.setattr(step_cls, "run", lambda self, cfg, state, n=name: ran.append(n))
    out_t = prepared["out_t"]
    cfg = tconf.DatasetConfig(general=dfc.general(prepared["dist"], out_t,
                                                  str(prepared["base"] / "masks"),
                                                  split_mode="fixed", n_test=1),
                              steps=dfc.PREP_STEPS)
    state = tcreate.create_dataset(cfg)
    assert ran == []
    assert state == prepared["state"]
    assert_same_tree(out_t, prepared["out_j"])


def test_cropping_is_not_skipped_after_a_crash(prepared):
    """A crash between a cropped tif's write and its meta's leaves the
    uncropped width in the meta: the lazy skip must not pass over it."""
    from satnerf_torch.data_prep.steps.step_cropping import ProcessingStep

    out_t, dist = prepared["out_t"], prepared["dist"]
    cfg = tconf.DatasetConfig(general=dfc.general(dist, out_t))
    state = {"image_dp": os.path.join(out_t, "images"),
             "metas_dp": os.path.join(out_t, "metas")}
    step = ProcessingStep(cfg, tconf.StepConfig(file="step_cropping"), state)
    assert step.can_be_skipped(cfg, state)
    name = next(n for n, (_, _, w, h) in prepared["windows"].items() if (w, h) != (96, 96))
    meta_fp = os.path.join(state["metas_dp"], name + ".json")
    meta = read_json(meta_fp)
    try:
        write_json(meta_fp, {**meta, "width": 96, "height": 96})
        assert not step.can_be_skipped(cfg, state)
        os.remove(os.path.join(out_t, "images_cropped", name + ".tif"))
        write_json(meta_fp, meta)
        assert not step.can_be_skipped(cfg, state)
    finally:
        write_json(meta_fp, meta)
        shutil.copy(os.path.join(prepared["out_j"], "images_cropped", name + ".tif"),
                    os.path.join(out_t, "images_cropped"))
    assert step.can_be_skipped(cfg, state)


class _BundleAdjustStub:
    """Stands in for the sat-bundleadjust package (``bundle_adjust``)."""

    class cam_utils:
        SatelliteImage = object


@pytest.mark.parametrize("mode, installed", [("external", False), ("external", True),
                                             ("auto", True)])
def test_external_mode_fails_as_the_jax_package(mode, installed, dist4, tmp_path,
                                                monkeypatch):
    if installed:
        monkeypatch.setitem(sys.modules, "bundle_adjust", _BundleAdjustStub)
        monkeypatch.setitem(sys.modules, "bundle_adjust.cam_utils", _BundleAdjustStub.cam_utils)
    else:
        monkeypatch.setitem(sys.modules, "bundle_adjust", None)
    errors = []
    for create, conf in ((tcreate, tconf), (jcreate, jconf)):
        out = str(tmp_path / create.__name__.split(".")[0])
        cfg = conf.DatasetConfig(general=dfc.general(dist4, out), steps=[ADAPTER, _ba(mode)])
        with pytest.raises(Exception) as exc:
            create.create_dataset(cfg)
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] is (NotImplementedError if installed else ModuleNotFoundError)


# ---------------------------------------------------------------------------
# the CLI, the datasets, training
# ---------------------------------------------------------------------------


def test_cli_copies_the_template_and_exits_0(tmp_path):
    fp = tmp_path / "sub" / "dataset.toml"
    out = subprocess.run([sys.executable, "-m", "satnerf_torch.data_prep.create_dataset",
                          str(fp)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    template = os.path.join(REPO, "satnerf_torch", "data_prep", "dataset_template.toml")
    assert fp.read_text() == open(template).read()
    assert tcreate.main([]) == 1


def _main_cfgs(prepared, which: str):
    from satnerf_torch import configs as tc
    from satnerf_tpu import configs as jc

    base = prepared["base"]
    run = dict(dataset_name="JAX_068", datasets_dp=str(base / which),
               cache_dp=str(base / f"cache_{which}"), workspace_dp=str(base / "training"),
               seed=0)
    pipe = dict(n_samples=8, fc_layers=2, fc_units=64, fc_skips=[1], batch_size=256,
                sparsity_n_images=1)
    mod = tc if which == "port" else jc
    return mod.MainConfig(mod.RunConfig(**run), mod.RSSemanticConfig(**pipe))


@pytest.fixture(scope="module")
def pipelines(prepared):
    from satnerf_torch.pipelines import load_pipeline as tload
    from satnerf_tpu.pipelines import load_pipeline as jload

    tp, jp = tload(_main_cfgs(prepared, "port")), jload(_main_cfgs(prepared, "jax"))
    tp.load_datasets()
    jp.load_datasets()
    return tp, jp


@pytest.mark.parametrize("split", ["rgb", "rgb_test", "depth"])
def test_datasets_on_the_prepared_directory_equal_the_jax_packages(pipelines, split):
    tp, jp = pipelines
    td, jd = tp.datasets[split], jp.datasets[split]
    assert td.data_names == jd.data_names and len(td) == len(jd) > 0
    assert set(td.combined) == set(jd.combined)
    for key, want in jd.combined.items():
        got = td.combined[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert td.normalization.params == jd.normalization.params
    if split == "rgb":
        assert set(np.unique(td.combined["semantic"])) <= set(range(5))


def test_training_steps_on_the_prepared_dataset(prepared, tmp_path):
    from torch_parity import TINY_PIPE

    from satnerf_torch.configs import write_toml
    from satnerf_torch.run import training

    toml = open(os.path.join(REPO, "configs", "pipelines", "rs_semantic.toml")).read()
    body = [ln for ln in toml.splitlines() if ln.split("=")[0].strip() not in TINY_PIPE]
    body += [f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
             for k, v in TINY_PIPE.items()]
    (tmp_path / "pipeline.toml").write_text("\n".join(body) + "\n")
    write_toml(str(tmp_path / "run.toml"), dict(
        dataset_name="JAX_068", datasets_dp=str(prepared["base"] / "port"),
        cache_dp=str(tmp_path / "cache"), workspace_dp=str(tmp_path / "training"),
        max_train_steps=4, num_sanity_val_steps=0, seed=0))
    pipeline, state, trainer = training.start_training(
        str(tmp_path / "run.toml"), str(tmp_path / "pipeline.toml"), device="cpu",
        log_every=1)
    assert state.step == 4 and len(trainer.history) == 4
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())
    assert pipeline.datasets["depth"].combined["rays"].shape[0] > 0
    val = trainer.val_history[-1]  # the validation at the run's end
    assert np.isfinite(val["train/mae"]) and np.isfinite(val["train/psnr"])


def test_port_imports_without_jax_pydantic_or_the_ba_toolchain(tmp_path):
    """Every port module, ``data_prep`` among them, and ``chip_smoke``
    import with JAX, the JAX package, pydantic, sat-bundleadjust, rasterio,
    Pillow and OpenCV blocked; every registry step is the port's; and the
    CLI builds a small dataset there (``auto`` falls to ``dsm``)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'satnerf_tpu', 'pydantic', 'bundle_adjust', 'rasterio', 'PIL',\n"
        "          'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import satnerf_torch\n"
        "for m in pkgutil.walk_packages(satnerf_torch.__path__, 'satnerf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from satnerf_torch.data_prep.create_dataset import STEP_REGISTRY, main\n"
        "assert all(v.startswith('satnerf_torch.data_prep.steps.')\n"
        "           for v in STEP_REGISTRY.values()), STEP_REGISTRY\n"
        "for v in STEP_REGISTRY.values():\n"
        "    importlib.import_module(v)\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_dfc_case as dfc\n"
        f"base = {str(tmp_path)!r}\n"
        "dist = dfc.write_distribution(base + '/raw', 3, 32, n_tie_points=40)\n"
        "steps = [{'file': 'adapter_dfc2019'}, {'file': 'step_bundle_adjustment'},\n"
        "         {'file': 'step_create_root_file'}, {'file': 'step_semantic'}]\n"
        "fp = dfc.write_config(base + '/cfg.toml', dfc.general(dist, base + '/out',\n"
        "    dist['masks_full'], split_mode='fixed', n_test=1), steps)\n"
        "assert main([fp]) == 0\n"
        "mods = [m for m in sys.modules if m.split('.')[0] in ('jax', 'satnerf_tpu',\n"
        "        'pydantic') and sys.modules[m] is not None]\n"
        "assert not mods, mods\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "bundle adjustment mode: dsm" in out.stdout + out.stderr
    assert os.path.isfile(tmp_path / "out" / "semantic_own" / "JAX_068_000_CLS.tif")


def test_the_ports_templates_are_package_data():
    """Each template a port CLI copies on first use ships with the package."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    found = glob.glob(os.path.join(REPO, "satnerf_torch", "**", "*_template.toml"),
                      recursive=True)
    assert len(found) == 2
    for fp in found:
        pkg = os.path.relpath(os.path.dirname(fp), REPO).replace(os.sep, ".")
        assert os.path.basename(fp) in data.get(pkg, []), (pkg, data)
