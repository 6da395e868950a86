"""The port's visualizers (``satnerf_torch/viz``) against the JAX package's
on the same inputs: a port run trained on the CPU (``train_tiny_run``), one
image of its test split and that image's render through the port. Every
visualizer's array is the JAX package's (exact for integer and colour maps,
1e-6 for floats), and so is its TensorBoard panel; the area downscale is
OpenCV's within one grey level; the TIF export carries the source image's
RPC tags; ``run_visualizer`` writes every TIF of a split; the CLS colour
PNG has the pixels of the JAX package's Pillow PNG.

The confusion-matrix panel differs by design: the JAX package draws a
matplotlib figure, the port the matrix's cells (``render_confusion_matrix_png``);
the port's panel is held to the cells of the JAX package's matrix."""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from satnerf_tpu import configs as jconfigs
from satnerf_tpu.eval import semantic_metrics as jsem
from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
from satnerf_tpu.viz import colormaps as jcm
from satnerf_tpu.viz import experimental_viz as jexp
from satnerf_tpu.viz import visualize as jviz
from satnerf_tpu.viz.extract_cls_viz import extract_cls_viz as jextract
from satnerf_torch.eval.semantic_metrics import render_confusion_matrix_png
from satnerf_torch.io.png import load_png
from satnerf_torch.io.tiff import read_geotiff, read_geotiff_profile
from satnerf_torch.render.renderer import render_image_chunked
from satnerf_torch.viz import colormaps as tcm
from satnerf_torch.viz import experimental_viz as texp
from satnerf_torch.viz import visualize as tviz
from satnerf_torch.viz.extract_cls_viz import extract_cls_viz as textract
from satnerf_torch.viz.run_visualizer import main as run_visualizer_main
from torch_parity import train_tiny_run

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny port run, its test image 1, that image's render (as numpy),
    and the JAX package's pipeline on the same configs and scene."""
    base = tmp_path_factory.mktemp("viz")
    pipeline, trainer = train_tiny_run(base, steps=12)
    ds = pipeline.datasets["rgb_test"]
    sample = ds.image_item(1)
    rcfg = dataclasses.replace(pipeline.step_config(1, device="cpu").render,
                               solar_correction=False)
    results = render_image_chunked(_best_params(trainer), rcfg, sample["rays"],
                                   sample["extras"], chunk=1024, device="cpu")
    jcfg = jconfigs.load_configs(str(base / "run.toml"), str(base / "pipeline.toml"))
    jcfg.run.cache_dp = str(base / "jcache")
    jpipe = jload_pipeline(jcfg)
    jpipe.load_datasets()
    return {"base": base, "pipeline": pipeline, "trainer": trainer, "sample": sample,
            "results": results, "jpipe": jpipe, "rcfg": rcfg}


def _best_params(trainer):
    """The params that ``run_visualizer`` reads: the run's best checkpoint."""
    from satnerf_torch.eval.loader import load_run

    return load_run(trainer.cfg.run.run_dp, load_datasets=False, device="cpu")[1]


def _same(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


def test_every_visualizer_gives_the_jax_packages_array(tiny):
    pipeline, jpipe = tiny["pipeline"], tiny["jpipe"]
    sample = dict(tiny["sample"])
    rng = np.random.default_rng(0)
    # a clean-label copy, so the non-corrupted summary has its ground truth
    clean = sample["semantic"].copy()
    clean[rng.random(clean.shape[0]) < 0.2] = 0
    sample["semantic_non_corrupted"] = clean
    results = tiny["results"]
    ds, jds = pipeline.datasets["rgb_test"], jpipe.datasets["rgb_test"]
    cfg = copy.deepcopy(pipeline.cfg)
    cfg.pipeline.semantic_dataset_type = "semantic_corrupted"
    jcfg = copy.deepcopy(jpipe.cfg)
    jcfg.pipeline.semantic_dataset_type = "semantic_corrupted"
    tvs = tviz.default_visualizers(cfg, semantic=True)
    jvs = jviz.default_visualizers(jcfg, semantic=True)
    assert [type(v).__name__ for v in tvs] == [type(v).__name__ for v in jvs]
    assert len(tvs) == 17
    w, h = sample["w"], sample["h"]
    for tv, jv in zip(tvs, jvs):
        name = tv._name()
        got = tv._visualize(ds, sample, results, w, h)
        want = jv._visualize(jds, sample, results, w, h)
        assert got is not None, name
        if name == "confusion_matrix":
            labels = list(jds.semantic_cls_labels.values())
            cm = jsem.confusion_matrix(results["semantic_label"], sample["semantic"],
                                       len(labels))
            _same(got, render_confusion_matrix_png(cm, labels).astype(np.float32) / 255.0,
                  name)
            continue
        _same(got, want, name)
        _same(tv._for_tensorboard(np.asarray(got)), jv._for_tensorboard(np.asarray(want)),
              name + "/tensorboard")


def test_experimental_visualizers_give_the_jax_packages_arrays():
    rng = np.random.default_rng(1)
    h, w, f = 28, 28, 6
    n = h * w
    results = {
        "dino": rng.normal(size=(n, f)).astype(np.float32),
        "neighbour_mask": rng.random(n) < 0.5,
        "semantic_label": rng.integers(0, 5, n),
        "neighbour_mean_sigma": np.concatenate(
            [rng.random((n, 2)), (rng.random((n, 1)) < 0.7)], 1).astype(np.float32),
    }
    results["neighbours"] = rng.random((int(results["neighbour_mask"].sum()), 5)).astype(
        np.float32)
    sample = {"w": w, "h": h, "dino": rng.normal(size=(4, f)).astype(np.float32),
              "dino_h": 2, "dino_w": 2, "dino_upscale": 1,
              "dino_mapping": (np.arange(n) // (n // 4)).astype(np.int64)}

    class Dataset:
        pca = None

    pairs = [(texp.TensorboardDinoSummaryVisualization, jexp.TensorboardDinoSummaryVisualization),
             (texp.NeighbourmaskVisualization, jexp.NeighbourmaskVisualization),
             (texp.DepthsRegVisualization, jexp.DepthsRegVisualization),
             (texp.DensityRegVisualization, jexp.DensityRegVisualization)]
    for tcls, jcls in pairs:
        got = tcls(None, True, False)._visualize(Dataset(), sample, results, w, h)
        want = jcls(None, True, False)._visualize(Dataset(), sample, results, w, h)
        _same(got, want, tcls.__name__)
    feats = rng.normal(size=(50, f)).astype(np.float32)
    _same(texp.FeaturePCA().fit(feats).transform(feats),
          jexp.FeaturePCA().fit(feats).transform(feats), "FeaturePCA")


@pytest.mark.parametrize("shape,size", [((3, 768, 768), 600), ((3, 96, 96), 400),
                                        ((3, 1000, 700), 400), ((1, 401, 97), 400)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_scale_for_tensorboard_is_opencvs_area_resize(shape, size, dtype):
    """Within one grey level of ``cv2.resize(INTER_AREA)`` (float images in
    [0, 1]: 1/255), the uint8 round trip included."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    got, want = tcm.scale_for_tensorboard(img, size), jcm.scale_for_tensorboard(img, size)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1.0 if dtype == "uint8" else 1.0 / 255
    assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= tol


def test_tif_export_carries_the_source_rpc_tags(tiny, tmp_path):
    """A visualizer's GeoTIFF: the JAX package's pixels and the source
    image's RPC tags."""
    sample, results = tiny["sample"], tiny["results"]
    ds, jds = tiny["pipeline"].datasets["rgb_test"], tiny["jpipe"].datasets["rgb_test"]
    cfg = tiny["pipeline"].cfg
    tv = [v for v in tviz.default_visualizers(cfg, semantic=True) if v._name() == "alts"][0]
    jv = [v for v in jviz.default_visualizers(tiny["jpipe"].cfg, semantic=True)
          if v._name() == "alts"][0]
    tviz.run_all([tv], ds, sample, results, split="test", epoch=3, run_dp=str(tmp_path / "t"))
    jviz.run_all([jv], jds, sample, results, split="test", epoch=3, run_dp=str(tmp_path / "j"))
    rel = os.path.join("visualization", "test", "alts", f"{sample['name']}_epoch_3.tif")
    got, prof = read_geotiff(str(tmp_path / "t" / rel))
    want, _ = read_geotiff(str(tmp_path / "j" / rel))
    np.testing.assert_array_equal(got, want)
    src = read_geotiff_profile(sample["img_fp"])
    assert src.rpc is not None and prof.rpc is not None
    for f in dataclasses.fields(src.rpc):
        np.testing.assert_array_equal(getattr(prof.rpc, f.name), getattr(src.rpc, f.name))


def test_run_visualizer_writes_every_tif_of_a_split(tiny, tmp_path):
    """The CLI on the port-trained run: one TIF per image for every
    visualizer that saves one, the rgb TIF equal to the render."""
    run_dp = tiny["trainer"].cfg.run.run_dp
    out = tmp_path / "viz"
    assert run_visualizer_main([run_dp, str(out), "--split", "test", "--device", "cpu"]) == 0
    ds = tiny["pipeline"].datasets["rgb_test"]
    tifs = [v for v in tviz.default_visualizers(tiny["pipeline"].cfg, semantic=True)
            if v.save_as_tif]
    assert len(tifs) == 11
    for i in range(len(ds.data)):
        item = ds.image_item(i)
        for v in tifs:
            fps = [f for f in os.listdir(out / "visualization" / item["split"] / v._name())
                   if f.startswith(item["name"] + "_epoch_")]
            assert len(fps) == 1, (v._name(), item["name"])
    item = ds.image_item(1)
    rgb_dp = out / "visualization" / "test" / "rgb"
    rgb, _ = read_geotiff(str(rgb_dp / os.listdir(rgb_dp)[0]))
    want = render_image_chunked(_best_params(tiny["trainer"]), tiny["rcfg"], item["rays"],
                                item["extras"], chunk=16384, device="cpu")["rgb"]
    np.testing.assert_array_equal(rgb, np.moveaxis(want.reshape(item["h"], item["w"], 3),
                                                   -1, 0))


def test_extract_cls_viz_png_is_the_jax_packages(tiny, tmp_path):
    from PIL import Image

    cls_fp = str(tiny["base"] / "datasets" / "SYN" / "SYN_001_CLS.tif")
    got = textract(cls_fp, str(tmp_path / "t.png"))
    want = jextract(cls_fp, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(load_png(got), np.asarray(Image.open(want)))
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))
