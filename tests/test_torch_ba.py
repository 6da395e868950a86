"""The port's native bundle adjustment (``satnerf_torch/data_prep/ba.py``)
against the JAX package's (``satnerf_tpu/data_prep/ba.py``) on the same
views of a generated scene: corners, matches, tracks, the triangulation, the
bias adjustment and ``run_native_ba``'s output contract
(``ba_params/*.npy``, ``geotiff_paths.txt``, ``rpcs_adj/*.rpc_adj``) and
stats. Both are the same float64 numpy code, so the bar is exact equality.
One property of ``tests/test_ba_native.py`` on the port alone: injected
per-view camera biases are recovered modulo the translation gauge."""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import pytest

import satnerf_torch.data_prep.ba as T
import satnerf_tpu.data_prep.ba as J
from satnerf_torch.datasets.synthetic import generate_scene
from satnerf_torch.geo.rpc import RPCModel
from satnerf_torch.io.json_io import read_json
from satnerf_torch.io.tiff import read_geotiff


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """(names, grays, rpcs, paths, altitude range) of 4 views of 96²."""
    dp = str(tmp_path_factory.mktemp("ba") / "SYN_BA")
    generate_scene(dp, n_train=4, n_test=0, img_size=96, n_tie_points=50)
    names, grays, rpcs, paths = [], [], [], []
    lo, hi = np.inf, -np.inf
    for fp in sorted(glob.glob(os.path.join(dp, "metas", "*.json"))):
        m = read_json(fp)
        img, _ = read_geotiff(os.path.join(dp, "images", m["img"]))
        names.append(m["img"][:-4])
        grays.append(T.to_gray(img))
        np.testing.assert_array_equal(grays[-1], J.to_gray(img))
        rpcs.append(RPCModel.from_dict(m["rpc"]))
        paths.append("/crops/" + m["img"])
        lo, hi = min(lo, m["min_alt"]), max(hi, m["max_alt"])
    return names, grays, rpcs, paths, (lo, hi)


def _jrpcs(rpcs):
    """The same cameras as the JAX package's RPCModel."""
    from satnerf_tpu.geo.rpc import RPCModel as JRPC

    return [JRPC.from_dict(r.to_dict()) for r in rpcs]


@pytest.fixture(scope="module")
def stages(views):
    """Every stage through both packages -> {stage: (port, jax)}."""
    _, grays, rpcs, _, alt = views
    jr = _jrpcs(rpcs)
    out = {"corners": ([T.harris_corners(g) for g in grays],
                       [J.harris_corners(g) for g in grays])}
    pairs = {}
    for i in range(len(grays)):
        for j in range(i + 1, len(grays)):
            ca, cb = out["corners"][0][i], out["corners"][0][j]
            pairs[(i, j)] = (T.match_pair(grays[i], grays[j], rpcs[i], rpcs[j], ca, cb, alt),
                             J.match_pair(grays[i], grays[j], jr[i], jr[j], ca, cb, alt))
    out["matches"] = pairs
    tm = {k: v[0] for k, v in pairs.items() if len(v[0])}
    out["tracks"] = (T.build_tracks(tm, out["corners"][0]),
                     J.build_tracks(tm, out["corners"][0]))
    tracks = out["tracks"][0]
    out["triangulated"] = (T.triangulate_tracks(tracks, rpcs, alt),
                           J.triangulate_tracks(tracks, jr, alt))
    pts, obs, mask = out["triangulated"][0]
    out["adjusted"] = (T.bundle_adjust(rpcs, pts, obs, mask),
                       J.bundle_adjust(jr, pts, obs, mask))
    return out


def test_harris_corners_equal(stages):
    port, jax_ = stages["corners"]
    for a, b in zip(port, jax_):
        assert a.dtype == b.dtype == np.float64 and len(a) >= 20
        np.testing.assert_array_equal(a, b)


def test_match_pair_equal(stages):
    n = 0
    for (i, j), (a, b) in stages["matches"].items():
        np.testing.assert_array_equal(a, b, err_msg=f"pair {i}-{j}")
        n += len(a)
    assert n > 20


def test_build_tracks_equal(stages):
    port, jax_ = stages["tracks"]
    assert port == jax_ and len(port) >= 10


@pytest.mark.parametrize("stage", ["triangulated", "adjusted"])
def test_geometry_solve_equal(stages, stage):
    port, jax_ = stages[stage]
    assert len(port) == len(jax_)
    for a, b in zip(port, jax_):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if stage == "adjusted":
        _, _, _, mask, res = port
        assert float(res[mask].mean()) < 1.0


def test_run_native_ba_contract_equal(views, tmp_path):
    names, grays, rpcs, paths, alt = views
    st = T.run_native_ba(names, grays, rpcs, paths, alt, str(tmp_path / "port"))
    sj = J.run_native_ba(names, grays, _jrpcs(rpcs), paths, alt, str(tmp_path / "jax"))
    assert st == sj and st["mean_reproj_px"] < 1.0
    for rel in ("ba_params/pts3d.npy", "ba_params/pts2d.npy", "ba_params/cam_ind.npy",
                "ba_params/pts_ind.npy"):
        a, b = np.load(tmp_path / "port" / rel), np.load(tmp_path / "jax" / rel)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=rel)
    for rel in ["ba_params/geotiff_paths.txt"] + [f"rpcs_adj/{n}.rpc_adj" for n in names]:
        assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text()
    adj = RPCModel.from_rpc_file(str(tmp_path / "port" / "rpcs_adj" / f"{names[1]}.rpc_adj"))
    np.testing.assert_allclose(adj.col_offset, rpcs[1].col_offset + st["bias_px"][1][0])


def _gauge_residual(rpcs, p0, bias, inject):
    """``bias + inject`` without its best-fit global-translation component
    (a rigid cloud shift delta maps to J_v @ delta in each view)."""
    steps = np.array([1e-6, 1e-6, 1.0])
    jac = np.zeros((len(rpcs), 2, 3))
    for v, rpc in enumerate(rpcs):
        for k in range(3):
            d = np.zeros(3)
            d[k] = steps[k]
            cp, rp = rpc.projection(*(p0 + d))
            cm, rm = rpc.projection(*(p0 - d))
            jac[v, :, k] = [(cp - cm) / (2 * steps[k]), (rp - rm) / (2 * steps[k])]
    e = bias + inject
    delta, *_ = np.linalg.lstsq(jac.reshape(-1, 3), e.reshape(-1), rcond=None)
    return e - (jac @ delta), delta


def test_port_recovers_an_injected_bias_modulo_the_gauge(views):
    """The geometry solver alone (observations projected through the true
    cameras plus 0.3 px noise, the cameras biased): the solved biases equal
    the injected ones up to the gauge, as ``tests/test_ba_native.py`` holds
    the JAX package."""
    _, _, rpcs_true, _, alt = views
    inject = np.array([[0.0, 0.0], [1.7, -2.3], [-2.1, 0.9], [0.8, 1.4]])
    rpcs = [dataclasses.replace(r, col_offset=r.col_offset + inject[v, 0],
                                row_offset=r.row_offset + inject[v, 1])
            for v, r in enumerate(rpcs_true)]
    rng = np.random.default_rng(0)
    n = 120
    r0 = rpcs_true[0]
    lon = r0.lon_offset + rng.uniform(-0.7, 0.7, n) * r0.lon_scale
    lat = r0.lat_offset + rng.uniform(-0.7, 0.7, n) * r0.lat_scale
    h = rng.uniform(alt[0] + 5, alt[1] - 5, n)
    obs = T._project_all(rpcs_true, lon, lat, h, None) + rng.normal(0, 0.3, (n, 4, 2))
    tracks = [dict(zip(range(4), map(tuple, o))) for o in obs]
    pts0, obs_t, mask_t = T.triangulate_tracks(tracks, rpcs, alt)
    pts, _, bias, mask, res = T.bundle_adjust(rpcs, pts0, obs_t, mask_t)
    assert float(res[mask].mean()) < 0.45
    resid, delta = _gauge_residual(rpcs, np.array([lon.mean(), lat.mean(), h.mean()]), bias,
                                   inject)
    assert np.abs(resid).max() < 0.2, (resid, delta)
    assert abs(float((pts[:, 2] - h).mean()) + delta[2]) < 0.5
