"""The port's datasets, synthetic scene, ray store, samplers and DSM/MAE
against the JAX package's on one generated scene: the same files, the same
rays, extras, rgbs, depth targets, weights, labels and sparsity masks (f32,
equal or within 1e-6), the same index streams, and the same altitude MAE
on the same depths (within 1e-4 m)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from satnerf_tpu import configs as jconfigs
from satnerf_tpu.datasets.synthetic import generate_scene as jgenerate
from satnerf_tpu.eval.dsm import compute_dsm_and_mae as jdsm_mae
from satnerf_tpu.io.tiff import read_geotiff
from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
from satnerf_tpu.train import data as jdata
from satnerf_torch import configs as tconfigs
from satnerf_torch.datasets.synthetic import generate_scene as tgenerate
from satnerf_torch.eval.dsm import compute_dsm_and_mae as tdsm_mae
from satnerf_torch.pipelines import load_pipeline as tload_pipeline
from satnerf_torch.train import data as tdata

torch.set_num_threads(2)
SCENE = dict(n_train=2, n_test=1, img_size=40, n_tie_points=80)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    jgenerate(str(base / "jax" / "SYN"), **SCENE)
    tgenerate(str(base / "port" / "SYN"), **SCENE)
    return base


def _cfgs(base, datasets_dp, cache, **pipe):
    run = dict(dataset_name="SYN", datasets_dp=str(datasets_dp), cache_dp=str(base / cache),
               workspace_dp=str(base / "training"), seed=0)
    pipe = dict(n_samples=8, fc_layers=2, fc_units=64, fc_skips=[1], batch_size=256,
                sparsity_n_images=1, **pipe)
    return (jconfigs.MainConfig(jconfigs.RunConfig(**run), jconfigs.RSSemanticConfig(**pipe)),
            tconfigs.MainConfig(tconfigs.RunConfig(**run), tconfigs.RSSemanticConfig(**pipe)))


@pytest.fixture(scope="module")
def pipelines(scenes):
    jcfg, tcfg = _cfgs(scenes, scenes / "jax", "cache_jax")
    _, tcfg_cached = _cfgs(scenes, scenes / "jax", "cache_jax")
    jp, tp = jload_pipeline(jcfg), tload_pipeline(tcfg)
    jp.load_datasets()
    tp.load_datasets()  # reads the rays the JAX package cached
    _, tcfg_fresh = _cfgs(scenes, scenes / "jax", "cache_port")
    tp_fresh = tload_pipeline(tcfg_fresh)
    tp_fresh.load_datasets()  # builds its own rays and cache
    return jp, tp, tp_fresh


def test_generate_scene_writes_the_reference_files(scenes):
    jdir, tdir = scenes / "jax" / "SYN", scenes / "port" / "SYN"
    jfiles = sorted(str(p.relative_to(jdir)) for p in jdir.rglob("*") if p.is_file())
    tfiles = sorted(str(p.relative_to(tdir)) for p in tdir.rglob("*") if p.is_file())
    assert jfiles == tfiles and len(jfiles) > 10
    for rel in jfiles:
        a, b = jdir / rel, tdir / rel
        if rel.endswith(".tif"):
            (ja, jp), (ta, tp) = read_geotiff(str(a)), read_geotiff(str(b))
            np.testing.assert_array_equal(ta, ja)
            assert (tp.transform, tp.epsg) == (jp.transform, jp.epsg)
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        else:
            assert b.read_bytes() == a.read_bytes(), rel


@pytest.mark.parametrize("split", ["rgb", "rgb_test", "depth"])
def test_datasets_give_the_reference_arrays(pipelines, split):
    jp, tp, tp_fresh = pipelines
    jd = jp.datasets[split]
    for port in (tp, tp_fresh):
        td = port.datasets[split]
        assert td.data_names == jd.data_names
        assert set(td.combined) == set(jd.combined)
        for key, want in jd.combined.items():
            got = td.combined[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if got.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
        assert td.normalization.params == jd.normalization.params
        for jitem, titem in zip(jd.data, td.data):
            assert {k: v for k, v in titem.items() if not isinstance(v, np.ndarray)} == \
                {k: v for k, v in jitem.items() if not isinstance(v, np.ndarray)}
    if split == "rgb":
        assert not tp.datasets[split].combined["semantic_sparsity_mask"].all()
    assert tp.n_classes == jp.n_classes == 5 and tp.car_index == jp.car_index == 4
    assert tp.ds_drop_step == jp.ds_drop_step


@pytest.mark.parametrize("kw", [dict(n=1000, batch_size=96), dict(n=1000, batch_size=96,
                                                                   shuffle=False),
                                dict(n=1000, batch_size=64, subsample=0.3),
                                dict(n=1000, batch_size=64, subsample=200, shuffle=False),
                                dict(n=300, batch_size=300, seed=1)])
def test_epoch_sampler_streams_equal_the_reference(kw):
    js, ts = jdata.EpochSampler(**kw), tdata.EpochSampler(**kw)
    assert ts.steps_per_epoch == js.steps_per_epoch and ts.epoch_size == js.epoch_size
    for _ in range(3 * js.steps_per_epoch + 2):
        np.testing.assert_array_equal(ts.next_batch(), js.next_batch())
        assert ts.epoch == js.epoch
    jf, tf = jdata.EpochSampler(**kw), tdata.EpochSampler(**kw)
    jf.fast_forward(2 * js.steps_per_epoch + 1)
    tf.fast_forward(2 * js.steps_per_epoch + 1)
    for _ in range(js.steps_per_epoch + 1):
        np.testing.assert_array_equal(tf.next_batch(), jf.next_batch())


def test_device_store_gathers_the_reference_batch(pipelines):
    import jax.numpy as jnp

    jp, tp, _ = pipelines
    comb = tp.datasets["rgb"].combined
    tstore = tdata.device_store(comb, tdata.TRAIN_KEYS, device="cpu")
    jstore = jdata.device_store(jp.datasets["rgb"].combined, jdata.TRAIN_KEYS)
    idx = tdata.EpochSampler(len(tp.datasets["rgb"]), 256, seed=0).next_batch()
    tb = tdata.gather_batch(tstore, torch.from_numpy(idx), prefix="x_")
    jb = jdata.gather_batch(jstore, jnp.asarray(idx), prefix="x_")
    assert set(tb) == set(jb) == {"x_" + k for k in tdata.TRAIN_KEYS}
    assert tb["x_semantic"].dtype == torch.int32
    assert tb["x_semantic_sparsity_mask"].dtype == torch.bool
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_dsm_mae_on_the_same_depths_matches_the_reference(pipelines, tmp_path):
    jp, tp, _ = pipelines
    jds, tds = jp.datasets["rgb_test"], tp.datasets["rgb_test"]
    item = tds.image_item(1)
    rng = np.random.default_rng(0)
    # depths near the rays' mid-point, so the DSM covers the scene
    depths = (item["rays"][:, 7] * (0.5 + 0.05 * rng.normal(size=len(item["rays"]))))
    depths = depths.astype(np.float32)
    tm = tdsm_mae(tds, item["rays"], depths, str(tmp_path / "t"), item["name"], 0)
    jm = jdsm_mae(jds, item["rays"], depths, str(tmp_path / "j"), item["name"], 0)
    assert abs(float(tm["mean"]) - float(jm["mean"])) <= 1e-4
    assert abs(float(tm["median"]) - float(jm["median"])) <= 1e-4
    assert np.isfinite(float(tm["mean"]))
    assert os.path.isfile(tmp_path / "t" / f"{item['name']}_DSM_epoch_0.tif")
