"""The port's host layer against the JAX package on the same seeded inputs:
geo (ellipsoid, UTM, RPC), io (GeoTIFF both ways, LZW), the native C++
library built by the port into ``build/``, scene normalization and RPC
rays, the dataclass configs against the pydantic ones, and the image
metrics. Geo, io, normalization and rays are copies of numpy code, so they
are held to f64 exactness (≤ 1e-12)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from satnerf_tpu import configs as jconfigs
from satnerf_tpu.core import normalization as jnorm
from satnerf_tpu.core import rays as jrays
from satnerf_tpu.eval import metrics as jmetrics
from satnerf_tpu.geo import ellipsoid as jell
from satnerf_tpu.geo import rpc as jrpc
from satnerf_tpu.geo import utm as jutm
from satnerf_tpu.geo.coordinate_systems import make_coordinate_system as jmake_cs
from satnerf_tpu.io import tiff as jtiff
from satnerf_tpu.ops import dsm_register as jreg
from satnerf_tpu.ops import rasterize as jrast
from satnerf_torch import configs as tconfigs
from satnerf_torch.core import normalization as tnorm
from satnerf_torch.core import rays as trays
from satnerf_torch.eval import metrics as tmetrics
from satnerf_torch.geo import ellipsoid as tell
from satnerf_torch.geo import rpc as trpc
from satnerf_torch.geo import utm as tutm
from satnerf_torch.geo.coordinate_systems import make_coordinate_system as tmake_cs
from satnerf_torch.io import tiff as ttiff
from satnerf_torch.ops import dsm_register as treg
from satnerf_torch.ops import native as tnative
from satnerf_torch.ops import rasterize as trast

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAT0, LON0 = 30.331, -81.661
EXACT = 1e-12


def _close(a, b, tol=EXACT):
    for x, y in zip(np.atleast_1d(a) if not isinstance(a, tuple) else a,
                    np.atleast_1d(b) if not isinstance(b, tuple) else b):
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                   rtol=tol, atol=tol)


def _latlonalt(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return (LAT0 + rng.uniform(-0.01, 0.01, n), LON0 + rng.uniform(-0.01, 0.01, n),
            rng.uniform(-20, 60, n))


def _rpc_pair():
    """The same linear RPC in both packages, fitted to a synthetic camera."""
    rng = np.random.default_rng(3)
    lat, lon, alt = _latlonalt(400, 4)
    col = (lon - LON0) * 9e4 + 0.3 * alt + rng.normal(0, 1e-3, lat.shape) + 500
    row = (LAT0 - lat) * 9e4 - 0.2 * alt + 500
    j = jrpc.fit_rpc_from_projections(lon, lat, alt, col, row)
    t = trpc.fit_rpc_from_projections(lon, lat, alt, col, row)
    return j, t


@pytest.mark.parametrize("fn", ["latlon_to_ecef", "ecef_to_latlon", "utm", "utm_inverse",
                                "rpc_projection", "rpc_localization"])
def test_geo_matches_the_reference(fn):
    lat, lon, alt = _latlonalt()
    if fn == "latlon_to_ecef":
        _close(tell.latlon_to_ecef(lat, lon, alt), jell.latlon_to_ecef(lat, lon, alt))
    elif fn == "ecef_to_latlon":
        x, y, z = jell.latlon_to_ecef(lat, lon, alt)
        _close(tell.ecef_to_latlon(x, y, z), jell.ecef_to_latlon(x, y, z))
    elif fn == "utm":
        te, tn, tz = tutm.utm_from_latlon(lat, lon)
        je, jn, jz = jutm.utm_from_latlon(lat, lon)
        assert tz == jz
        _close((te, tn), (je, jn))
    elif fn == "utm_inverse":
        e, n, z = jutm.utm_from_latlon(lat, lon)
        _close(tutm.latlon_from_utm(e, n, z), jutm.latlon_from_utm(e, n, z))
    else:
        j, t = _rpc_pair()
        assert t.to_dict() == j.to_dict()
        if fn == "rpc_projection":
            _close(t.projection(lon, lat, alt), j.projection(lon, lat, alt))
        else:
            col, row = j.projection(lon, lat, alt)
            _close(t.localization(col, row, alt), j.localization(col, row, alt))


@pytest.mark.parametrize("utm", [False, True])
def test_rpc_rays_sun_and_normalization_match_the_reference(utm):
    j, t = _rpc_pair()
    zone = jutm.latlon_to_zone_string(LAT0, LON0)
    rows, cols = np.meshgrid(np.arange(0, 40, 3.0), np.arange(0, 30, 2.5))
    rj = jrays.build_rays_from_rpc(j, jmake_cs(utm, zone), rows, cols, -10.0, 50.0)
    rt = trays.build_rays_from_rpc(t, tmake_cs(utm, zone), rows, cols, -10.0, 50.0)
    assert rt.dtype == np.float32
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(trays.construct_sun_dir(55.0, 140.0, 7),
                                  jrays.construct_sun_dir(55.0, 140.0, 7))
    nj, nt = jnorm.SceneNormalization.from_rays(rj), tnorm.SceneNormalization.from_rays(rt)
    assert nt.params == nj.params
    np.testing.assert_array_equal(nt.normalize_rays(rt), nj.normalize_rays(rj))
    xyz = rj[:, :3].astype(np.float64)
    _close(nt.denormalize_xyz(nt.normalize_xyz(xyz)), nj.denormalize_xyz(nj.normalize_xyz(xyz)))
    # the torch-tensor path of set_ray_component
    far = torch.from_numpy(rt)
    out = trays.set_ray_component(far, "far", 2.0)
    assert torch.all(out[:, 7] == 2.0) and torch.equal(far, torch.from_numpy(rt))


@pytest.mark.parametrize("writer", ["jax_package", "port"])
@pytest.mark.parametrize("dtype,compress", [("float32", True), ("uint8", False),
                                            ("uint16", True), ("float64", False)])
def test_geotiff_written_by_one_package_reads_in_the_other(tmp_path, writer, dtype, compress):
    rng = np.random.default_rng(0)
    arr = (rng.uniform(0, 200, (3, 17, 23))).astype(dtype)
    write, read = ((jtiff.write_geotiff, ttiff.read_geotiff) if writer == "jax_package"
                   else (ttiff.write_geotiff, jtiff.read_geotiff))
    prof_cls = jtiff.GeoProfile if writer == "jax_package" else ttiff.GeoProfile
    prof = prof_cls(width=23, height=17, count=3, dtype=dtype,
                    transform=(0.5, 0.5, 432100.0, 3355000.0), epsg=32617,
                    nodata=float("nan") if dtype.startswith("float") else None)
    fp = str(tmp_path / "x.tif")
    write(fp, arr, prof, compress=compress)
    got, gprof = read(fp)
    np.testing.assert_array_equal(got, arr)
    assert (gprof.width, gprof.height, gprof.count, gprof.epsg) == (23, 17, 3, 32617)
    assert tuple(gprof.transform) == prof.transform


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first, early change) encoder for a fixture."""
    out, acc, nbits, bits = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, nbits
        acc = (acc << bits) | code
        nbits += bits
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 0xFF)
            nbits -= 8

    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b""
    put(256)
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << bits) and bits < 12:
            bits += 1
        if nxt >= 4094:
            put(256)
            table, nxt, bits = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([ch])
    if w:
        put(table[w])
    put(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def test_native_library_is_built_into_build_and_decodes_lzw():
    lib = tnative.get_lib()
    assert lib is not None  # g++ is on this machine, as on the card's
    path = tnative.lib_path()
    assert os.path.isfile(path)
    assert os.path.relpath(path, REPO).startswith(os.path.join("build", "satnerf_torch"))
    payload = bytes(np.random.default_rng(1).integers(0, 7, 20000, dtype=np.uint8)) * 2
    stream = _lzw_encode(payload)
    assert ttiff._lzw_decode(stream, len(payload)) == payload
    assert ttiff._lzw_decode(stream, 0) == jtiff._lzw_decode(stream, 0) == payload


@pytest.mark.parametrize("fn", ["rasterize_mean", "ncc", "recursive_ncc", "apply_shift",
                                "downsample2x"])
def test_native_host_kernels_match_the_reference(fn):
    rng = np.random.default_rng(2)
    if fn == "rasterize_mean":
        cloud = np.stack([rng.uniform(0, 50, 3000), rng.uniform(-50, 0, 3000),
                          rng.uniform(0, 30, 3000)], axis=1)
        cloud[::97] = np.nan
        args = (cloud, 0.0, 0.0, 0.5, 100, 100)
        np.testing.assert_array_equal(trast.rasterize_mean(*args, radius=1),
                                      jrast.rasterize_mean(*args, radius=1))
        return
    u = rng.normal(size=(130, 120)).cumsum(0).cumsum(1)
    v = np.roll(u, (2, -3), axis=(0, 1)) * 1.1 + 0.5
    v[5:9, 10:30] = np.nan
    if fn == "ncc":
        assert treg.ncc(u, v, 1, -2) == jreg.ncc(u, v, 1, -2)
    elif fn == "recursive_ncc":
        assert treg.compute_shift(u, v) == jreg.compute_shift(u, v)
    elif fn == "apply_shift":
        np.testing.assert_array_equal(treg.apply_shift(v, 2, -1, 1.2, 0.3),
                                      jreg.apply_shift(v, 2, -1, 1.2, 0.3))
    else:
        np.testing.assert_array_equal(treg.downsample2x(v), jreg.downsample2x(v))


# -- configs ------------------------------------------------------------------

PIPELINES = ["nerf", "snerf", "satnerf", "rs_semantic"]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_configs_load_equal_to_the_reference_and_dump_reloads_equal(tmp_path, pipeline):
    run_fp = tmp_path / "run.toml"
    run_fp.write_text('seed = 3\nmax_train_steps = 40\nlearnrate_typo = 1\n'
                      'dataset_name = "SYN"\ndevice_req_free = false\n')
    pipe_fp = os.path.join(REPO, "configs", "pipelines", f"{pipeline}.toml")
    j = jconfigs.load_configs(str(run_fp), pipe_fp)
    t = tconfigs.load_configs(str(run_fp), pipe_fp)
    assert type(t.pipeline).__name__ == type(j.pipeline).__name__
    assert t.run.dump_dict() == j.run.model_dump()
    assert t.pipeline.dump_dict() == j.pipeline.model_dump()
    assert t.pipeline.variant == j.pipeline.variant
    assert t.pipeline.use_mapping == j.pipeline.use_mapping
    assert t.run.dataset_dp == j.run.dataset_dp
    assert t.create_run_name()[19:] == j.create_run_name()[19:]  # past the stamp
    t.dump(str(tmp_path / "logs"))
    again = tconfigs.load_configs(str(tmp_path / "logs" / "run.toml"),
                                  str(tmp_path / "logs" / "pipeline.toml"))
    assert again.run == t.run and again.pipeline == t.pipeline


@pytest.mark.parametrize("kw", [dict(learnrate=1), dict(n_samples=8.0), dict(n_samples="8"),
                                dict(depth_enabled=1), dict(depth_enabled="false"),
                                dict(fc_skips=(1, 2.0)), dict(sc_lambda="0.5"),
                                dict(n_samples=8.5), dict(depth_enabled=2),
                                dict(pipeline=3)])
def test_dataclass_configs_coerce_as_pydantic(kw):
    try:
        want = jconfigs.RSSemanticConfig(**kw).model_dump()
    except Exception:
        with pytest.raises(ValueError):
            tconfigs.RSSemanticConfig(**kw)
        return
    got = tconfigs.RSSemanticConfig(**kw).dump_dict()
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)


def test_step_config_of_a_pipeline_is_the_toml_mapping(tmp_path):
    from satnerf_torch.pipelines import load_pipeline

    pipe_fp = os.path.join(REPO, "configs", "pipelines", "satnerf.toml")
    run_fp = tmp_path / "run.toml"
    run_fp.write_text("seed = 0\n")
    cfg = tconfigs.load_configs(str(run_fp), pipe_fp)
    pipe = load_pipeline(cfg)
    got = pipe.step_config(10, device="cpu")
    want = tconfigs.step_config_from_pipeline(tconfigs.load_pipeline_toml(pipe_fp), 10,
                                             n_classes=1, device="cpu")
    assert got == want
    assert pipe.ds_drop_step == round(0.25 * 300000)
    assert pipe.visualizers() == []


def test_trunk_impl_resolves_to_the_kernels_on_the_card():
    """On a CUDA device every engine name runs the kernels, at any width
    (the flagship TOML names none, which the reference reads as "xla"; a
    width the kernels are not built for raises at their launch); on the CPU
    it stays."""
    for impl in ("xla", "pallas", "auto"):
        assert tconfigs.resolve_trunk_impl(impl, "cuda") == "pallas"
    p64 = {"pipeline": "rs_semantic", "fc_units": 64}
    assert tconfigs.render_config_from_pipeline(p64, device="cuda").field.trunk_impl == "pallas"
    assert tconfigs.resolve_trunk_impl("xla", "cpu") == "xla"
    assert tconfigs.resolve_trunk_impl("auto", "cpu") == "xla"
    assert tconfigs.resolve_trunk_impl("pallas", "cpu") == "pallas"
    p = tconfigs.load_pipeline_toml(os.path.join(REPO, "configs", "pipelines",
                                                 "rs_semantic.toml"))
    assert "trunk_impl" not in p
    assert tconfigs.render_config_from_pipeline(p, device="cuda").field.trunk_impl == "pallas"


@pytest.mark.parametrize("impl,plain_trunk", [("xla", 1), ("pallas", 0)])
def test_layer_by_layer_trunk_counts_as_a_plain_call(impl, plain_trunk):
    """The field's layer-by-layer trunk counts each call in
    ``models.field.PLAIN_CALLS``; the kernels' path (their plain version on
    the CPU) counts in the kernel module instead."""
    from satnerf_torch.models import field as fld
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.train.state import init_params

    p = {"pipeline": "rs_semantic", "fc_layers": 2, "fc_units": 256, "fc_skips": [],
         "trunk_impl": impl}
    cfg = tconfigs.render_config_from_pipeline(p, device="cpu").field
    params = init_params(torch.Generator().manual_seed(0), cfg, t_vocab=3, device="cpu")
    rng = np.random.default_rng(0)
    n = 16
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    sun = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    t_emb = torch.from_numpy(rng.normal(size=(n, cfg.t_embedding_tau)).astype(np.float32))
    before, ff_before = fld.PLAIN_CALLS, ff.PLAIN_CALLS
    with torch.no_grad():
        out = fld.field_forward(params["field"], cfg, xyz, sun_d=sun, t_emb=t_emb)
    assert torch.isfinite(out["rgb"]).all()
    assert fld.PLAIN_CALLS - before == plain_trunk
    assert ff.PLAIN_CALLS - ff_before == 1 - plain_trunk


def test_matmul_precision_maps_to_torch():
    from satnerf_torch.run.training import apply_matmul_precision

    before = torch.get_float32_matmul_precision()
    try:
        for name, want in (("highest", "highest"), ("high", "high"), ("default", "medium")):
            apply_matmul_precision(name)
            assert torch.get_float32_matmul_precision() == want
    finally:
        torch.set_float32_matmul_precision(before)


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("shape,window", [((40, 37, 3), 3), ((33, 20, 3), 5), ((25, 31), 4)])
def test_psnr_and_ssim_match_the_reference(shape, window):
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    b[:5] = a[:5]  # flat windows: the SSIM variance terms near 0
    assert abs(float(tmetrics.psnr(a, b)) - float(jmetrics.psnr(a, b))) <= 1e-5
    ts = float(tmetrics.ssim(a, b, window_size=window, sigma=1.5))
    js = float(jmetrics.ssim(a, b, window_size=window, sigma=1.5))
    assert abs(ts - js) <= 1e-6
    assert float(tmetrics.ssim(a, a)) <= 1.0 + 1e-7
    mask = rng.uniform(size=shape) > 0.3
    assert abs(float(tmetrics.mse(a, b, mask)) - float(jmetrics.mse(a, b, mask))) <= 1e-7
