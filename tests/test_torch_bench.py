"""The port's measurement scripts (``satnerf_torch.bench`` and
``satnerf_torch.tools.{render_bench,speed_of_light,feed_rate}``) against
the JAX package's (the root ``bench.py``, ``__graft_entry__._batch`` and
``tools/``), on the CPU.

- The synthetic batch: bitwise.
- The bench's settings against the JAX bench's module constants under the
  same ``SATNERF_BENCH_*`` values (the JAX bench reloaded under a patched
  environment, and reloaded again after): equal but for the engine part of
  the label. On the card both trunk engines run the kernels, so the trunk
  backward knob applies where the JAX bench drops it off its Pallas trunk.
- One training step at the bench's configuration, cut to a 2 x 64 field and
  48 + 16 rays, in f32, from the same parameters on the deterministic ladder
  (JAX ``key=None``), at tests/test_torch_step.py's bars: the default
  (``sc_stride`` 2) and the hierarchical variant (128 fine rungs, a fine
  field, remat 2).
- render_bench's chunk against JAX ``render_rays(..., key=None)``: rgb,
  depth and semantic logits within 1e-5 in f32 and within 0.1 in bf16 (the
  bar of tests/test_pallas_trunk.py:78 between two engines), with and
  without the solar-correction pass.
- speed_of_light's point and FLOP counts against the JAX tool's (read from
  the shapes it draws), and its gemm+plain_sin chain against the same chain in
  ``jax.numpy`` with the JAX ``fast_sin``.
- feed_rate's index stream against the JAX ``EpochSampler``'s, across epoch
  boundaries, with ``--spd`` 1 and 4.
- Each of the four CLIs refuses a machine without a card: a non-zero exit
  and no measured value printed.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from satnerf_tpu.models.field import FieldConfig as JFieldConfig
from satnerf_tpu.ops.fastmath import fast_sin as jfast_sin
from satnerf_tpu.render import renderer as jrender
from satnerf_tpu.train import data as jdata
from satnerf_tpu.train import step as jstep
from satnerf_tpu.train.state import create_train_state as jcreate_train_state
from satnerf_tpu.train.state import make_optimizer
from satnerf_torch import bench as tbench
from satnerf_torch.models.import_params import params_from_jax
from satnerf_torch.ops.fastmath import fast_sin
from satnerf_torch.tools import feed_rate, render_bench, speed_of_light
from satnerf_torch.train import data as tdata
from satnerf_torch.train import step as tstep
from satnerf_torch.train.state import create_train_state
from test_torch_step import LR, _check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_VARS = ("SATNERF_BENCH_BATCH", "SATNERF_BENCH_IMPL", "SATNERF_BENCH_REMAT_CHUNKS",
              "SATNERF_BENCH_HIER", "SATNERF_BENCH_SIN", "SATNERF_BENCH_SC_STRIDE",
              "SATNERF_BENCH_BWD")
SMALL = dict(layers=2, feat=64, skips=(1,))  # the field's cut for the CPU
RAYS, DEPTH_RAYS = 48, 16


@pytest.mark.parametrize("b,seed,semantic,depth", [
    (8, 0, True, 0), (48, 0, True, 16), (33, 5, False, 7), (1024, 2, True, 1024)])
def test_synthetic_batch_is_the_jax_benchs_bitwise(b, seed, semantic, depth):
    want = __graft_entry__._batch(b, seed, semantic, depth)
    got = tbench.synthetic_batch(b, seed, semantic, depth, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# -- settings -------------------------------------------------------------------------


@pytest.fixture
def jax_bench(monkeypatch):
    """-> load(env): the JAX bench module reloaded under ``env`` (every
    SATNERF_BENCH_* variable not in it unset); reloaded under the restored
    environment after the test."""
    import bench

    def load(env: dict):
        for k in BENCH_VARS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        return importlib.reload(bench)

    yield load
    monkeypatch.undo()
    importlib.reload(bench)


def _without_engine(label: str) -> str:
    """A bench label without its engine segment and its backward segment."""
    parts = label.split("/")
    return "/".join([parts[0]] + [p for p in parts[2:] if not p.startswith("bwd-")])


# env, the port's trunk backward
SETTINGS_CASES = {
    "default": ({}, "recompute"),
    "hier128": ({"SATNERF_BENCH_HIER": "128"}, "recompute"),
    "sc_stride1": ({"SATNERF_BENCH_SC_STRIDE": "1"}, "recompute"),
    "poly5": ({"SATNERF_BENCH_SIN": "poly5"}, "recompute"),
    "sin_auto": ({"SATNERF_BENCH_SIN": "auto"}, "recompute"),
    "bwd_auto_8192": ({"SATNERF_BENCH_BWD": "auto"}, "stored"),
    "bwd_auto_16384": ({"SATNERF_BENCH_BWD": "auto", "SATNERF_BENCH_BATCH": "16384"},
                       "recompute"),
    "bwd_stored_xla": ({"SATNERF_BENCH_BWD": "stored", "SATNERF_BENCH_IMPL": "xla"},
                       "stored"),
    "bwd_stored_pallas": ({"SATNERF_BENCH_BWD": "stored", "SATNERF_BENCH_IMPL": "pallas"},
                          "stored"),
    "hier_batch_remat": ({"SATNERF_BENCH_HIER": "64", "SATNERF_BENCH_BATCH": "2048",
                          "SATNERF_BENCH_REMAT_CHUNKS": "4"}, "recompute"),
}


@pytest.mark.parametrize("case", sorted(SETTINGS_CASES))
def test_settings_are_the_jax_benchs(case, jax_bench):
    env, bwd = SETTINGS_CASES[case]
    jb = jax_bench(env)
    s = tbench.settings(env)
    assert (s.batch, s.remat_chunks, s.hier, s.sin, s.sc_stride, tbench.DEPTH_RAYS) == (
        jb.BATCH_SIZE, jb.REMAT_CHUNKS, jb.HIER_N_IMPORTANCE, jb.SIN_IMPL, jb.SC_STRIDE,
        jb.DEPTH_RAYS)
    # the JAX bench drops the backward knob off its Pallas trunk; the port
    # has no IMPL (the card runs the kernels) and reads none
    assert s == tbench.settings({k: v for k, v in env.items() if k != "SATNERF_BENCH_IMPL"})
    assert s.trunk_bwd == bwd
    if jb.TRUNK_IMPL == "pallas" or bwd == "recompute":
        assert s.trunk_bwd == jb.TRUNK_BWD
    assert s.engine == "kernels"
    assert _without_engine(s.config_desc) == _without_engine(jb.CONFIG_DESC)
    assert s.config_desc.split("/")[1] == "kernels"
    assert ("/bwd-stored" in s.config_desc) == (bwd == "stored")
    assert jb.SCAN_STEPS == tbench.SCAN_STEPS
    assert jb.REFERENCE_RAYS_PER_SEC == tbench.REFERENCE_RAYS_PER_SEC


@pytest.mark.parametrize("var,value", [("SATNERF_BENCH_SIN", "fast"),
                                       ("SATNERF_BENCH_BWD", "both")])
def test_settings_refuse_what_the_jax_bench_refuses(var, value, jax_bench):
    with pytest.raises(AssertionError) as jerr:
        jax_bench({var: value})
    with pytest.raises(ValueError) as terr:
        tbench.settings({var: value})
    assert str(terr.value) == str(jerr.value)


def test_exact_sine_and_the_cpu_run_the_plain_field():
    s = tbench.settings({"SATNERF_BENCH_SIN": "exact", "SATNERF_BENCH_BWD": "stored"})
    assert (s.engine, s.trunk_bwd) == ("plain", "recompute")
    assert s.config_desc == "batch8192/plain/chunks0/bf16/exact/sc2"
    # the kernels' configuration: the fused field on the card, its plain
    # version (the layer-by-layer field) on the CPU
    s = tbench.settings({})
    assert tbench.configs(s, "cpu")[0].trunk_impl == "xla"
    assert tbench.configs(s, "cuda")[0].trunk_impl == "pallas"


def test_configs_are_the_jax_benchs(jax_bench):
    """Every field the two packages' configs share holds the JAX bench's
    value (bench.py:247-264), but the trunk engine: on the card the port's
    runs the kernels."""
    jb = jax_bench({"SATNERF_BENCH_HIER": "128"})
    fcfg, rcfg, scfg = tbench.configs(tbench.settings({"SATNERF_BENCH_HIER": "128"}), "cuda")
    jf, jr, js = _jax_configs(jb)
    assert fcfg.trunk_impl == "pallas"
    for got, want in ((fcfg, jf), (rcfg, jr), (scfg, js)):
        shared = {f.name for f in dataclasses.fields(got)} & {
            f.name for f in dataclasses.fields(want)}
        assert len(shared) > 6
        for name in shared - {"field", "render", "trunk_impl"}:
            assert getattr(got, name) == getattr(want, name), name


def _jax_configs(jb, **field):
    """The JAX bench's configs under its current module constants
    (bench.py:247-264), the field replaced by ``field``."""
    jf = JFieldConfig(variant="rs_semantic", mapping=True, siren=True, n_classes=5,
                      trunk_impl=jb.TRUNK_IMPL, sin_impl=jb.SIN_IMPL, trunk_bwd=jb.TRUNK_BWD,
                      **field)
    jr = jrender.RenderConfig(field=jf, n_samples=64, solar_correction=True,
                              compute_dtype="bfloat16", remat_chunks=jb.REMAT_CHUNKS,
                              sc_stride=jb.SC_STRIDE, n_importance=jb.HIER_N_IMPORTANCE,
                              use_fine_network=jb.HIER_N_IMPORTANCE > 0)
    js = jstep.StepConfig(render=jr, steps_per_epoch=1000, sc_lambda=0.05,
                          first_beta_epoch=0, depth=True, semantic=True, car_index=4,
                          use_car_reg_loss=True, car_reg_loss_start=0)
    return jf, jr, js


# -- one training step ------------------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"SATNERF_BENCH_HIER": "128"}],
                         ids=["default_sc_stride2", "hier128"])
def test_one_step_at_the_bench_configuration_matches_jax(env, jax_bench):
    jb = jax_bench(env)
    jf, jr, js = _jax_configs(jb, **SMALL)
    jr = dataclasses.replace(jr, compute_dtype="float32")
    js = dataclasses.replace(js, render=jr)
    fine = jb.HIER_N_IMPORTANCE > 0
    opt = make_optimizer(LR, steps_per_epoch=1000)
    jstate = jcreate_train_state(jax.random.PRNGKey(0), jf, opt, t_vocab=50,
                                 use_fine_network=fine)
    batch = __graft_entry__._batch(RAYS, depth=DEPTH_RAYS)
    new_state, jm = jax.jit(jstep.build_train_step(js, opt))(jstate, batch, None)

    fcfg, rcfg, scfg = tbench.configs(tbench.settings(env), "cpu")
    fcfg = dataclasses.replace(fcfg, **SMALL)
    rcfg = dataclasses.replace(rcfg, field=fcfg, compute_dtype="float32")
    scfg = dataclasses.replace(scfg, render=rcfg)
    assert (rcfg.sc_stride, rcfg.n_importance, rcfg.use_fine_network) == (
        jr.sc_stride, jr.n_importance, jr.use_fine_network)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), fcfg, device="cpu")
    tstate = create_train_state(params, LR, steps_per_epoch=1000)
    tstate, tm = tstep.build_train_step(scfg)(
        tstate, tbench.synthetic_batch(RAYS, depth=DEPTH_RAYS, device="cpu"))
    want = params_from_jax(jax.tree.map(np.asarray, new_state.params), fcfg, device="cpu")
    _check(jm, tm, tstate, want)
    if fine:
        assert "c_coarse_color" in tm
        _check(jm, tm, types.SimpleNamespace(params={"field": tstate.params["fine"],
                                                     "t": tstate.params["t"]}),
               {"field": want["fine"], "t": want["t"]})


# -- render_bench -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.1)])
@pytest.mark.parametrize("with_sc", [False, True], ids=["no_sc", "sc"])
def test_render_bench_chunk_matches_jax(dtype, tol, with_sc):
    env = {"SATNERF_RENDER_DTYPE": dtype, "SATNERF_RENDER_SC": "1" if with_sc else "0",
           "SATNERF_RENDER_CHUNK": "64"}
    s = render_bench.settings(env)
    assert (s.chunk, s.sin, s.scan) == (64, "poly", 50)
    rcfg = render_bench.render_config(s, "cpu")
    rcfg = dataclasses.replace(rcfg, field=dataclasses.replace(rcfg.field, **SMALL))
    jf = JFieldConfig(variant="rs_semantic", mapping=True, siren=True, n_classes=5,
                      sin_impl=s.sin, **SMALL)
    jr = jrender.RenderConfig(field=jf, n_samples=64, solar_correction=with_sc,
                              compute_dtype=dtype)
    jstate = jcreate_train_state(jax.random.PRNGKey(0), jf, make_optimizer(5e-4, "step", 1000),
                                 t_vocab=50)
    b = __graft_entry__._batch(s.chunk)
    want = jrender.render_rays(jstate.params, jr, b["rays"], b["extras"], key=None)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), rcfg.field, device="cpu")
    tb = tbench.synthetic_batch(s.chunk, device="cpu")
    got = render_bench.render_chunk(params, rcfg, tb["rays"], tb["extras"])
    keys = ("rgb", "depth", "semantic_logits") + (("sun_sc",) if with_sc else ())
    for k in keys:
        err = float(np.max(np.abs(got[k].float().numpy() - np.asarray(want[k], np.float32))))
        assert err <= tol, (k, err)
    total = float(render_bench.chunk_sum(got, with_sc))
    assert total == pytest.approx(sum(float(got[k].float().sum()) for k in keys), rel=1e-6)


# -- speed_of_light ---------------------------------------------------------------------


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Drawn(Exception):
    pass


@pytest.mark.parametrize("batch,samples,stride", [(8192, 64, 1), (8192, 64, 2),
                                                  (1000, 63, 2), (96, 10, 3), (17, 5, 4)])
def test_speed_of_light_counts_are_the_jax_tools(batch, samples, stride, monkeypatch):
    """The JAX tool's point count and weight shapes, read from the arrays it
    draws before its first jit (which stops it here)."""
    shapes = []
    normal = jax.random.normal

    def recording_normal(key, shape, dtype=jnp.float32):
        shapes.append(tuple(shape))
        return normal(key, (1,) * len(shape), dtype)

    def stop(*args, **kwargs):
        raise _Drawn

    monkeypatch.setattr(jax.random, "normal", recording_normal)
    monkeypatch.setattr(jax, "jit", stop)
    with pytest.raises(_Drawn):
        _jax_tool("speed_of_light").main(["--batch", str(batch), "--samples", str(samples),
                                          "--sc-stride", str(stride)])
    *w_shapes, x_shape = shapes
    n_points = speed_of_light.point_count(batch, samples, stride)
    assert n_points == x_shape[0] and x_shape[1] == speed_of_light.XYZ_IN
    ws = speed_of_light.chain_weights(8, 512, torch.float32, "cpu")
    assert [tuple(w.shape) for w in ws] == w_shapes
    jax_flops = 2 * x_shape[0] * sum(a * b for a, b in w_shapes)
    assert speed_of_light.gemm_flops(n_points, ws) == jax_flops


def test_speed_of_light_chain_matches_jax():
    rng = np.random.default_rng(0)
    xyz_in = speed_of_light.XYZ_IN
    shapes = [(xyz_in, 64), (64, 64), (64, 64), (64, 64), (64 + xyz_in, 64), (64, 64)]
    ws = [(rng.normal(size=shape) * 0.1).astype(np.float32) for shape in shapes]
    x0 = rng.normal(size=(40, speed_of_light.XYZ_IN)).astype(np.float32)

    def jchain(x0, ws, passes):
        x, sums = x0, []
        for _ in range(passes):
            h = x
            for i, w in enumerate(ws):
                if i in speed_of_light.SKIPS:
                    h = jnp.concatenate([h, x], axis=-1)
                h = jfast_sin(h @ w)
            sums.append(h.sum())
            x = h[:, :speed_of_light.XYZ_IN].astype(x.dtype)
        return np.asarray(jnp.stack(sums))

    with jax.default_matmul_precision("highest"):
        want = jchain(jnp.asarray(x0), [jnp.asarray(w) for w in ws], 2)
    got = speed_of_light.chain(torch.from_numpy(x0), [torch.from_numpy(w) for w in ws],
                               fast_sin, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# -- feed_rate --------------------------------------------------------------------------


@pytest.mark.parametrize("spd", [1, 4])
def test_feed_rate_index_stream_is_the_jax_samplers(spd):
    n, batch = 1000, 96  # 10 batches an epoch, the tail of 40 dropped
    tsampler, jsampler = tdata.EpochSampler(n, batch, seed=0), jdata.EpochSampler(n, batch,
                                                                                 seed=0)
    tsampler.next_batch(), jsampler.next_batch()
    for _ in range(30 // spd):  # three epochs
        got = feed_rate.draw(tsampler, spd)
        want = (jsampler.next_batch() if spd == 1
                else np.stack([jsampler.next_batch() for _ in range(spd)]))
        np.testing.assert_array_equal(got, want)
    assert tsampler.epoch == jsampler.epoch >= 2
    parts = feed_rate.shards(got, 4)
    assert len(parts) == 4 and all(p.shape[-1] == batch // 4 for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts, axis=-1), got)


def test_feed_rate_feeds_each_device_its_slice():
    sampler = tdata.EpochSampler(1000, 96, seed=0)
    sampler.next_batch()
    seconds = feed_rate.feed(sampler, [torch.device("cpu")] * 2, 4, 70)
    assert seconds > 0 and sampler.epoch >= 27


# -- the CLIs refuse the CPU ------------------------------------------------------------


def test_the_clis_refuse_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mods = ("satnerf_torch.bench", "satnerf_torch.tools.render_bench",
            "satnerf_torch.tools.speed_of_light", "satnerf_torch.tools.feed_rate")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SATNERF_")}
    procs = {m: subprocess.Popen([sys.executable, "-m", m], cwd=REPO, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for m in mods}
    for m, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode != 0, (m, out)
        assert "CUDA device requested" in err, (m, err[-500:])
        assert not any(w in out for w in ("value", "rays_per_s", "rows", "FEED_RATE")), (m, out)
