"""Serving a trained port run by view name, on the CPU, against the JAX
package: ``build_view_rays`` (rays within 1e-6 abs, extras exact),
``RenderService.from_run(...).render(name)`` against the JAX package's
``build_view_rays`` + ``render_image_chunked`` on the same ``best``
checkpoint (rgb 5e-5, depth 1e-4, semantic labels equal except where the
two largest logits lie within 1e-4), the HTTP routes and status codes as
``tests/test_serve.py`` holds them for the JAX package, the PNG codec, the
colormaps, and the serve CLI refusing to run on the CPU unasked.

The run is a tiny one trained through the port's CLI
(``torch_parity.train_tiny_run``); the JAX side reads the same run configs
and the same checkpoint through ``params_from_lightning_ckpt``."""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_parity import train_tiny_run

from satnerf_torch.eval.render_view import build_view_rays
from satnerf_torch.io.json_io import read_json
from satnerf_torch.io.png import decode_png, encode_png
from satnerf_torch.serve import http_server
from satnerf_torch.serve.service import RenderService
from satnerf_torch.viz.colormaps import apply_colormap

CHUNK = 2048
SUN = (30.0, 120.0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from satnerf_tpu import configs as jconfigs
    from satnerf_tpu.models.import_torch import params_from_lightning_ckpt
    from satnerf_tpu.pipelines import load_pipeline as jload_pipeline

    pipeline, _ = train_tiny_run(tmp_path_factory.mktemp("serve_view"))
    run_dp = pipeline.cfg.run.run_dp
    jcfg = jconfigs.load_configs_from_logs(run_dp)
    jpipe = jload_pipeline(jcfg)
    jpipe.load_datasets()
    jrcfg = dataclasses.replace(jpipe.step_config(steps_per_epoch=1, with_depth=False).render,
                                solar_correction=False)
    jparams = params_from_lightning_ckpt(os.path.join(run_dp, "ckpoints", "best.ckpt"),
                                         jrcfg.field, t_vocab=50)
    svc = RenderService.from_run(run_dp, chunk=CHUNK, device="cpu")
    return {"run_dp": run_dp, "svc": svc, "jpipe": jpipe, "jrcfg": jrcfg, "jparams": jparams}


def _metas(svc) -> dict:
    meta_dp = svc.dataset.meta_dp
    return {fn[:-5]: read_json(os.path.join(meta_dp, fn))
            for fn in sorted(os.listdir(meta_dp)) if fn.endswith(".json")}


@pytest.mark.parametrize("overrides", [{}, {"sun_elevation": SUN[0], "sun_azimuth": SUN[1],
                                            "ts": 1}], ids=["meta_sun", "relit_redated"])
def test_build_view_rays_matches_the_jax_package(run, overrides):
    from satnerf_tpu.eval.render_view import build_view_rays as jbuild

    metas = _metas(run["svc"])
    assert len(metas) == 3  # every view of the scene, the test view included
    for name, meta in metas.items():
        got = build_view_rays(run["svc"].dataset, meta, **overrides)
        want = jbuild(run["jpipe"].datasets["rgb"], meta, **overrides)
        assert float(np.abs(got[0] - want[0]).max()) <= 1e-6, name
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:], name


def _jax_render(run, name, **overrides):
    from satnerf_tpu.eval.render_view import build_view_rays as jbuild
    from satnerf_tpu.render.renderer import render_image_chunked as jrender

    meta = _metas(run["svc"])[name]
    rays, extras, w, h, _, _ = jbuild(run["jpipe"].datasets["rgb"], meta, **overrides)
    res = jrender(run["jparams"], run["jrcfg"], rays, extras, chunk=CHUNK)
    return {k: np.asarray(v) for k, v in res.items()}, h, w


@pytest.mark.parametrize("relit", [False, True])
def test_render_by_view_name_matches_the_jax_package(run, relit):
    svc = run["svc"]
    overrides = {"sun_elevation": SUN[0], "sun_azimuth": SUN[1], "ts": 1} if relit else {}
    for name in svc.view_names():
        got = svc.render(name, **overrides)
        want, h, w = _jax_render(run, name, **overrides)
        assert got["rgb"].shape == (h, w, 3)
        assert float(np.abs(got["rgb"] - np.clip(want["rgb"], 0, 1).reshape(h, w, 3)).max()) <= 5e-5
        assert float(np.abs(got["depth"] - want["depth"].reshape(h, w)).max()) <= 1e-4
        top2 = np.sort(want["semantic_logits"], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0] > 1e-4).reshape(h, w)
        np.testing.assert_array_equal(got["semantic_label"][clear],
                                      want["semantic_label"].reshape(h, w)[clear])
        if relit:
            assert (got["sun_elevation"], got["sun_azimuth"], got["ts"]) == (*SUN, 1)


def test_metadata_has_the_jax_package_keys_and_values(run):
    from satnerf_tpu.serve.service import RenderService as JRenderService

    svc = run["svc"]
    ref = object.__new__(JRenderService)  # its own constructor reads orbax checkpoints
    ref.run_dp, ref.step, ref.chunk, ref.fast_sine = svc.run_dp, svc.step, CHUNK, False
    ref.rcfg, ref.dataset = run["jrcfg"], run["jpipe"].datasets["rgb"]
    assert svc.metadata() == ref.metadata()
    best = torch.load(os.path.join(svc.run_dp, "ckpoints", "best.ckpt"), weights_only=True)
    assert svc.step == best["step"] > 0


def test_load_run_reads_one_checkpoint_once(run, monkeypatch):
    """``load_run``: epoch snapshot, else best, else last; one read of the
    file; fields on the device in eval mode; solar correction off."""
    from satnerf_torch.eval import loader
    from satnerf_torch.models.field import Field

    reads = []
    real = loader.torch.load
    monkeypatch.setattr(loader.torch, "load", lambda fp, **kw: reads.append(fp) or real(fp, **kw))
    pipeline, params, rcfg, step = loader.load_run(run["run_dp"], epoch=7, device="cpu")
    assert [os.path.basename(fp) for fp in reads] == ["best.ckpt"]  # no epoch_7: best
    assert step == run["svc"].step and not rcfg.solar_correction
    assert isinstance(params["field"], Field) and not params["field"].training
    assert set(params) == {"field", "t"} and pipeline.loaded


def test_unknown_view_raises_and_paths_stay_in_the_meta_dir(run):
    svc = run["svc"]
    with pytest.raises(KeyError):
        svc.render("NO_SUCH_VIEW")
    with pytest.raises(KeyError, match="escapes"):
        svc.resolve_meta("../x", allow_paths=False)
    with pytest.raises(ValueError, match="view name"):
        svc.resolve_meta({"width": 4, "height": 4}, allow_paths=False)
    meta_fp = os.path.join(svc.dataset.meta_dp, svc.view_names()[0] + ".json")
    assert svc.resolve_meta(meta_fp) == read_json(meta_fp)  # the Python API takes paths


@pytest.fixture(scope="module")
def endpoint(run):
    server, port = http_server.serve_in_thread(run["svc"], port=0)
    yield f"http://127.0.0.1:{port}"
    server.shutdown()
    server.server_close()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def _get(url):
    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_http_routes_and_status_codes(endpoint, run):
    svc = run["svc"]
    status, health = _get(endpoint + "/healthz")
    assert status == 200 and health == {"status": "ok", "step": svc.step}
    status, meta = _get(endpoint + "/metadata")
    assert status == 200 and meta == json.loads(json.dumps(svc.metadata()))
    requests0 = svc.stats()["requests"]

    view = meta["views"][0]
    served = svc.render(view)
    want = {"rgb": (served["rgb"] * 255).astype(np.uint8),
            "depth": (apply_colormap(served["depth"], "jet") * 255).astype(np.uint8),
            "semantic": served["semantic_rgb"], "semantic_shaded": served["semantic_shaded_rgb"]}
    for output, img in want.items():
        status, ctype, body = _post(endpoint + "/render", {"view": view, "output": output})
        assert status == 200 and ctype == "image/png"
        np.testing.assert_array_equal(decode_png(body), img)

    status, ctype, body = _post(endpoint + "/render",
                                {"view": view, "output": "arrays", "sun_elevation": 45.0})
    assert status == 200 and ctype == "application/json"
    payload = json.loads(body)
    rgb = np.frombuffer(base64.b64decode(payload["rgb_f16_b64"]), np.float16)
    depth = np.frombuffer(base64.b64decode(payload["depth_f16_b64"]), np.float16)
    relit = svc.render(view, sun_elevation=45.0)
    assert payload["shape"] == [40, 40, 3] and payload["sun_elevation"] == 45.0
    assert float(np.abs(rgb.reshape(40, 40, 3) - relit["rgb"]).max()) <= 1e-3
    assert float(np.abs(depth.reshape(40, 40) - relit["depth"]).max()
                 / np.abs(relit["depth"]).max()) <= 1e-3
    assert np.abs(relit["rgb"] - served["rgb"]).mean() > 1e-4  # the sun moved the shading

    status, _, body = _post(endpoint + "/render", {"view": "NO_SUCH_VIEW"})
    err = json.loads(body)["error"]
    assert status == 400 and "NO_SUCH_VIEW" in err
    assert "/" not in err.replace("NO_SUCH_VIEW", "")  # no server paths in a 400 body
    status, _, body = _post(endpoint + "/render", {"view": {"width": 50000, "height": 50000,
                                                            "min_alt": 0.0, "max_alt": 1.0}})
    assert status == 400 and "view name" in json.loads(body)["error"]
    for evil in ("/etc/passwd", "../../../../etc/passwd", "../root", "../x"):
        status, _, body = _post(endpoint + "/render", {"view": evil})
        assert status == 400, (evil, body)
    status, _, _ = _post(endpoint + "/render", {"view": view, "ts": None})
    assert status == 200  # a null ts reads as 0
    status, _, body = _post(endpoint + "/render", {"view": view, "sun_elevation": "noon"})
    assert status in (400, 500) and "error" in json.loads(body)
    status, _, body = _post(endpoint + "/render", {"view": view, "output": "bogus"})
    assert status == 400
    status, _, body = _post(endpoint + "/nope", {"view": view})
    assert status == 404
    status, _ = _get(endpoint + "/nope")
    assert status == 404

    status, stats = _get(endpoint + "/stats")
    # rendered: 2 direct calls, 5 good requests, the null ts and the bogus
    # output (refused after its render); the other 400s never reach a render
    assert status == 200 and stats["requests"] - requests0 == 9
    assert stats["rays_per_second"] > 0


def test_fast_sine_service_renders_poly5(run):
    fast = RenderService.from_run(run["run_dp"], chunk=CHUNK, fast_sine=True, device="cpu")
    base = run["svc"]
    assert fast.rcfg.field.sin_impl == "poly5" and base.rcfg.field.sin_impl == "poly"
    assert fast.metadata()["fast_sine"] and fast.metadata()["depth_quality"] == "poly5_fast_sine"
    name = base.view_names()[0]
    a, b = base.render(name)["rgb"], fast.render(name)["rgb"]
    assert np.max(np.abs(a - b)) < 5e-2 and np.mean(np.abs(a - b)) < 2e-3
    # against the JAX package's poly5 render of the same view
    jrcfg = run["jrcfg"]
    run5 = dict(run, jrcfg=dataclasses.replace(
        jrcfg, field=dataclasses.replace(jrcfg.field, sin_impl="poly5")))
    want, h, w = _jax_render(run5, name)
    assert float(np.abs(b - np.clip(want["rgb"], 0, 1).reshape(h, w, 3)).max()) <= 5e-5


def test_load_service_warms_up_and_the_cli_parses_its_flags(run, monkeypatch):
    import satnerf_torch.serve.__main__ as cli
    from satnerf_torch.serve.service import load_service

    svc = load_service(run["run_dp"], chunk=CHUNK, device="cpu")
    assert svc.stats()["requests"] == 1  # the warm-up render
    seen = {}
    monkeypatch.setattr(http_server, "serve", lambda run_dp, **kw: seen.update(kw, run_dp=run_dp))
    cli.main(["/tmp/run", "--port", "0", "--fast-sine", "--device", "cpu"])
    assert seen == {"run_dp": "/tmp/run", "port": 0, "fast_sine": True, "device": "cpu"}
    seen.clear()
    cli.main(["/tmp/run", "--fast-sine", "0"])
    assert seen == {"run_dp": "/tmp/run", "fast_sine": False}


def test_serve_cli_without_a_gpu_raises_instead_of_running_on_the_cpu(run):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import satnerf_torch.serve.__main__ as cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([run["run_dp"], "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        RenderService.from_run(run["run_dp"])


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 3), (7, 5, 4), (1, 1, 3)],
                         ids=["gray", "rgb", "rgba", "one_pixel"])
def test_png_round_trips_through_pillow(shape):
    from PIL import Image

    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("cmap", ["bone", "jet", "viridis", "unknown"])
def test_colormaps_equal_the_jax_package(cmap):
    from satnerf_tpu.viz.colormaps import apply_colormap as japply

    x = np.random.default_rng(3).normal(size=(33, 17))
    x[0, 0], x[1, 1] = np.nan, np.inf
    np.testing.assert_array_equal(apply_colormap(x, cmap), japply(x, cmap))
    ramp = np.linspace(0.0, 1.0, 256).reshape(16, 16)  # every table entry
    np.testing.assert_array_equal(apply_colormap(ramp, cmap), japply(ramp, cmap))


def test_port_runs_without_pillow_or_matplotlib():
    """The card machine has neither: no port module imports them, and the
    PNG, colormap and confusion-matrix code runs with both blocked."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('PIL', 'matplotlib', 'cv2'): sys.modules[m] = None\n"
        "import numpy as np, satnerf_torch\n"
        "for m in pkgutil.walk_packages(satnerf_torch.__path__, 'satnerf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from satnerf_torch.io.png import decode_png, encode_png\n"
        "from satnerf_torch.viz.colormaps import apply_colormap\n"
        "from satnerf_torch.eval.semantic_metrics import render_confusion_matrix_png\n"
        "img = (apply_colormap(np.arange(12.).reshape(3, 4), 'jet') * 255).astype(np.uint8)\n"
        "assert (decode_png(encode_png(img)) == img).all()\n"
        "assert render_confusion_matrix_png(np.eye(2), ['a', 'b']).shape == (3, 64, 64)\n"
        "import chip_smoke\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
