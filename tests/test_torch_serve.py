"""satnerf_torch serving path and package rules.

- A JAX-trained checkpoint (``save_lightning_ckpt``) loads into
  ``RenderService.from_checkpoint`` and renders what JAX's
  ``render_image_chunked`` renders (5e-5 abs in f32).
- Pipeline TOMLs map to the same field and render configs as the JAX
  package's ``step_config_from_main``.
- Entry points default to CUDA and raise without it; the package imports
  with JAX blocked, and neither it nor ``chip_smoke.py`` imports JAX or
  ``satnerf_tpu``.
The kernels themselves are held against their plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from satnerf_tpu.configs import PIPELINE_REGISTRY, MainConfig, RunConfig
from satnerf_tpu.data_prep.prepare_annotations import SEMANTIC_CLASS_COLOR_MAPPING
from satnerf_tpu.models.field import init_field_params
from satnerf_tpu.models.import_torch import save_lightning_ckpt
from satnerf_tpu.render import renderer as jr
from satnerf_tpu.train.step import step_config_from_main
from satnerf_torch import configs as tconfigs
from satnerf_torch.device import resolve_device
from satnerf_torch.models.import_params import load_lightning_ckpt
from satnerf_torch.render import renderer as tr
from satnerf_torch.serve import service as tservice
from torch_parity import max_err, synthetic_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINES = os.path.join(REPO, "configs", "pipelines")

SMALL_PIPELINE = """
pipeline = "rs_semantic"
fc_units = 256
fc_layers = 4
fc_skips = [2]
n_samples = 16
t_embedding_vocab = 5
sc_lambda = 0.05
"""


def _jax_render_config(pipe_fp: str):
    with open(pipe_fp, "rb") as f:
        import tomllib

        d = tomllib.load(f)
    cls = PIPELINE_REGISTRY[d.get("pipeline", "nerf")]
    d = {k: v for k, v in d.items() if k in cls.model_fields}
    cfg = MainConfig(RunConfig(dataset_name="X"), cls(**d))
    return step_config_from_main(cfg, steps_per_epoch=1).render


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A JAX-initialised rs_semantic checkpoint + its pipeline TOML."""
    dp = tmp_path_factory.mktemp("serve")
    pipe_fp = str(dp / "pipeline.toml")
    with open(pipe_fp, "w") as f:
        f.write(SMALL_PIPELINE)
    rcfg = _jax_render_config(pipe_fp)
    field = jax.tree.map(np.array,
                         init_field_params(jax.random.PRNGKey(0), rcfg.field))
    table = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    params = {"field": field, "t": table}
    ckpt_fp = save_lightning_ckpt(params, str(dp / "last.ckpt"))
    return ckpt_fp, pipe_fp, params, rcfg


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_checkpoint_service_matches_jax(small_ckpt, impl):
    ckpt_fp, pipe_fp, params, rcfg = small_ckpt
    h, w = 5, 9
    rays, extras = synthetic_rays(h * w, seed=4)
    ref = jr.render_image_chunked(
        params, dataclasses.replace(rcfg, solar_correction=False), rays, extras,
        chunk=16,
    )
    svc = tservice.RenderService.from_checkpoint(
        ckpt_fp, pipe_fp, device="cpu", chunk=16, trunk_impl=impl
    )
    assert not svc.rcfg.solar_correction
    assert svc.rcfg.field.trunk_impl == impl
    out = svc.render_rays(rays, extras, h, w)
    assert set(out) == {"rgb", "depth", "semantic_label", "semantic_rgb",
                        "semantic_shaded_rgb"}
    assert out["rgb"].shape == (h, w, 3) and out["depth"].shape == (h, w)
    assert max_err(out["rgb"], np.clip(ref["rgb"], 0, 1).reshape(h, w, 3)) < 5e-5
    assert max_err(out["depth"], ref["depth"].reshape(h, w)) < 5e-5
    labels = ref["semantic_label"].reshape(h, w)
    assert np.array_equal(out["semantic_label"], labels)
    assert np.array_equal(out["semantic_rgb"], SEMANTIC_CLASS_COLOR_MAPPING[labels])
    shading = (ref["weights"][..., None] * ref["sun"]).sum(-2).reshape(h, w, 1)
    shaded = (SEMANTIC_CLASS_COLOR_MAPPING[labels] * shading).astype(np.uint8)
    assert np.abs(out["semantic_shaded_rgb"].astype(int) - shaded).max() <= 1
    stats = svc.stats()
    assert stats["requests"] == 1 and stats["rays"] == h * w


def test_load_lightning_ckpt_round_trips_the_weights(small_ckpt):
    ckpt_fp, _, params, _ = small_ckpt
    loaded = load_lightning_ckpt(ckpt_fp)
    assert set(loaded) == {"field", "t"}
    assert np.array_equal(loaded["t"].numpy(), params["t"])
    w0 = loaded["field"]["fc_net.0.weight"].numpy()
    assert np.array_equal(w0, params["field"]["trunk"][0]["w"].T)


def test_class_colours_match_the_reference():
    assert np.array_equal(tservice.SEMANTIC_CLASS_COLOR_MAPPING,
                          SEMANTIC_CLASS_COLOR_MAPPING)


# -- configs --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["nerf", "snerf", "satnerf", "rs_semantic"])
def test_pipeline_toml_maps_like_jax(name):
    fp = os.path.join(PIPELINES, f"{name}.toml")
    ref = dataclasses.asdict(_jax_render_config(fp))
    got = dataclasses.asdict(tconfigs.load_render_config(fp, device="cpu"))
    assert got == ref


def test_trunk_impl_auto_resolves_by_device():
    fp = os.path.join(PIPELINES, "rs_semantic.toml")
    on_cuda = tconfigs.load_render_config(fp, device="cuda", trunk_impl="auto")
    on_cpu = tconfigs.load_render_config(fp, device="cpu", trunk_impl="auto")
    assert on_cuda.field.trunk_impl == "pallas"
    assert on_cpu.field.trunk_impl == "xla"


# -- devices: CUDA by default, never a silent CPU fallback -------------------------


def test_default_device_is_cuda_and_raises_without_it(small_ckpt):
    ckpt_fp, pipe_fp, _, _ = small_ckpt
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tservice.RenderService.from_checkpoint(ckpt_fp, pipe_fp)
    rcfg = tconfigs.load_render_config(pipe_fp, device="cpu")
    rays, extras = synthetic_rays(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.render_image_chunked({"field": None}, rcfg, rays, extras)


def test_wrappers_refuse_other_devices():
    from satnerf_torch.ops import composite, field_fused

    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        composite.composite(meta, meta, meta, meta, meta)
    spec = field_fused.FieldSpec(layers=2, feat=128, skips=(), c_in=3, fl=128,
                                 tau=4, n_classes=5, has_beta=True,
                                 has_semantic=True, use_tj_for_s=False,
                                 sep_t_s=False)
    with pytest.raises(ValueError):
        field_fused.fused_field(spec, meta, meta, {})


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    from satnerf_torch.ops import _build

    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(("composite",))


# -- package rules ----------------------------------------------------------------


def _imported_modules(fp: str) -> set:
    with open(fp) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dp, _, fns in os.walk(os.path.join(REPO, "satnerf_torch")):
        files += [os.path.join(dp, fn) for fn in fns if fn.endswith(".py")]
    assert len(files) > 15
    for fp in files:
        for name in _imported_modules(fp):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "satnerf_tpu", "flax", "optax"), (fp, name)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import satnerf_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(satnerf_torch.__path__, 'satnerf_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert not any(k.startswith('satnerf_tpu') for k in sys.modules)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
