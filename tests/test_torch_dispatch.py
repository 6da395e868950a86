"""Steps per dispatch in the port's training loop (``train/loop.py``,
``train/dispatch.py``) against the JAX package's, on the CPU.

* The block plan: both trainers on one generated scene (2 train views of
  40 x 40, batch 512: epochs of 6 steps; 40 steps: the depth drop at 10),
  log every 4, step callbacks at 5 and 7, K = 4; every ``trace.step(step,
  block)`` call recorded. The JAX trainer's step programs are stood in for
  by functions that only advance the step (its plan reads no result).
* K = 4 against K = 1 in the port: parameters, Adam's moments and count,
  and the logged history bitwise equal (on the CPU a block is K calls).
* The loss gates and the learning rate that the step reads from the device
  against the JAX step's: beta either side of ``first_beta_epoch`` and
  inside a ramp, car-reg either side of ``car_reg_loss_start``, every
  schedule. The gates are equal; the learning rate is the port's schedule
  in f64 rounded once to f32, the JAX one raises f32(0.9) to the epoch in
  f32, so at these epochs (at most 8) they are within 1e-6 of each other
  (``tests/test_torch_gate_settings.py`` holds 1e-5 at epoch 125).
* The checkpoint round trip of Adam's device state (moments, count, learning
  rate), restored in place, a ``torch.optim.Adam`` state read into it, and
  the trace window aligned to blocks as ``tests/test_aux.py`` holds the JAX
  one.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu import configs as jconfigs
from satnerf_torch import configs as tconfigs
from satnerf_torch.datasets.synthetic import generate_scene
from satnerf_torch.pipelines import load_pipeline
from satnerf_torch.train import step as tstep
from satnerf_torch.train.checkpoint import CheckpointManager, export_params
from satnerf_torch.train.loop import Trainer
from satnerf_torch.train.profiling import TraceCapture
from satnerf_torch.train.state import create_train_state
from satnerf_torch.train.state import init_params as tinit_params
from torch_parity import synthetic_rays

torch.set_num_threads(2)
PIPE = dict(n_samples=8, fc_layers=2, fc_units=64, fc_skips=[1], batch_size=512,
            render_chunk_size=4096, first_beta_epoch=1, depth_enabled=True,
            use_car_reg_loss=True, car_reg_loss_start=2)
STEPS, LOG_EVERY, K = 40, 4, 4
CALLBACKS = (5, 7)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    base = tmp_path_factory.mktemp("dispatch")
    generate_scene(str(base / "datasets" / "SYN"), n_train=2, n_test=1, img_size=40,
                   n_tie_points=80)
    return base


def _cfg(mod, base, name: str, spd: int):
    """``mod``: either package's ``configs``."""
    run = mod.RunConfig(dataset_name="SYN", datasets_dp=str(base / "datasets"),
                        cache_dp=str(base / f"cache_{name}"),
                        workspace_dp=str(base / f"training_{name}"), max_train_steps=STEPS,
                        num_sanity_val_steps=0, seed=0, steps_per_dispatch=spd)
    return mod.MainConfig(run, mod.RSSemanticConfig(**PIPE))


def _recorded(trainer) -> list:
    calls = []
    trainer.trace.step = lambda step, block=1: calls.append((step, block))
    return calls


def _port_run(base, name: str, spd: int):
    pipeline = load_pipeline(_cfg(tconfigs, base, name, spd))
    pipeline.prepare_run()
    pipeline.load_datasets()
    trainer = Trainer(pipeline, log_every=LOG_EVERY, device="cpu")
    calls = _recorded(trainer)
    seen = []
    state = trainer.fit(validate_every_epoch=False, step_callbacks={
        s: (lambda st, i: seen.append((i, st.step))) for s in CALLBACKS})
    return {"trainer": trainer, "state": state, "calls": calls, "seen": seen}


@pytest.fixture(scope="module")
def port_runs(workspace):
    return {spd: _port_run(workspace, f"k{spd}", spd) for spd in (1, K)}


def test_block_plan_equals_the_jax_loops(workspace, port_runs, monkeypatch):
    from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
    from satnerf_tpu.train import loop as jloop

    def make_step_fn(scfg, optimizer, with_depth, mesh=None, scan_steps=1):
        def fn(state, store, depth_store, idx, didx, key, step0):
            return (state.replace(step=state.step + scan_steps),
                    {"loss": jnp.zeros(()), "psnr": jnp.zeros(())})
        return fn

    monkeypatch.setattr(jloop, "_make_step_fn", make_step_fn)
    pipeline = jload_pipeline(_cfg(jconfigs, workspace, "jax", K))
    pipeline.prepare_run()
    pipeline.load_datasets()
    trainer = jloop.Trainer(pipeline, log_every=LOG_EVERY)
    calls = _recorded(trainer)
    trainer.fit(validate_every_epoch=False, step_callbacks={
        s: (lambda st, i: None) for s in CALLBACKS})

    port = port_runs[K]
    tp = port["trainer"]
    assert (tp.pipeline.ds_drop_step, len(tp.pipeline.datasets["rgb"]) // PIPE["batch_size"]) \
        == (10, 6)
    assert port["calls"] == calls
    assert sum(b for _, b in calls) == STEPS
    assert (0, K) in calls and (10, 1) in calls and {b for _, b in calls} == {1, K}
    assert tp.profiler.counts["train_step"] == len(calls)
    assert port["seen"] == [(5, 5), (7, 7)]
    assert port_runs[1]["calls"] == [(s, 1) for s in range(STEPS)]


def test_k4_equals_k1_bitwise(port_runs):
    one, four = port_runs[1], port_runs[K]
    assert one["state"].step == four["state"].step == STEPS
    pa, pb = export_params(one["state"].params), export_params(four["state"].params)
    assert set(pa) == set(pb)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    oa, ob = one["state"].optimizer, four["state"].optimizer
    assert torch.equal(oa.count, ob.count) and int(ob.count) == STEPS
    assert all(torch.equal(a, b) for a, b in zip(oa.exp_avg + oa.exp_avg_sq,
                                                 ob.exp_avg + ob.exp_avg_sq))
    assert one["trainer"].history == four["trainer"].history
    assert [h["step"] for h in four["trainer"].history] == list(range(4, STEPS + 1, 4))


def _step_case(**step_kw):
    """(port StepConfig, JAX StepConfig, port params, JAX params, port batch,
    JAX batch): a 3 x 64 rs_semantic field, 8 rays with depth, 8 samples."""
    from satnerf_torch.models.field import FieldConfig
    from satnerf_torch.models.import_params import params_from_jax
    from satnerf_torch.render import renderer as trender
    from satnerf_tpu.models.field import FieldConfig as JFieldConfig
    from satnerf_tpu.render import renderer as jrender
    from satnerf_tpu.train import step as jstep
    from satnerf_tpu.train.state import init_params as jinit_params

    fkw = dict(variant="rs_semantic", layers=3, feat=64, skips=(1,), mapping=True)
    jf, tf = JFieldConfig(**fkw), FieldConfig(**fkw)
    skw = dict(steps_per_epoch=4, depth=True, semantic=True, car_index=4,
               use_car_reg_loss=True, car_reg_loss_start=3, first_beta_epoch=2,
               use_beta_for_s=True, **step_kw)
    jscfg = jstep.StepConfig(render=jrender.RenderConfig(field=jf, n_samples=8), **skw)
    tscfg = tstep.StepConfig(render=trender.RenderConfig(field=tf, n_samples=8), **skw)
    jparams = jinit_params(jax.random.PRNGKey(0), jf, t_vocab=5)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tf, device="cpu")
    rays, extras = synthetic_rays(8, 0, vocab=5)
    rng = np.random.default_rng(1)
    batch = {"rays": rays, "extras": extras,
             "rgbs": rng.uniform(0, 1, (8, 3)).astype(np.float32),
             "semantic": rng.integers(0, 5, (8, 1)).astype(np.int32),
             "semantic_sparsity_mask": np.ones(8, bool),
             "depth_rays": rays[:4], "depth_extras": extras[:4],
             "depth_depths": np.full((4,), 1.0, np.float32),
             "depth_weights": np.ones((4,), np.float32)}
    return (tscfg, jscfg, tparams, jparams,
            {k: torch.from_numpy(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("ramp", [0.0, 1.5], ids=["step_gate", "ramp"])
def test_device_gates_equal_the_jax_steps(ramp):
    from satnerf_tpu.train import step as jstep

    tscfg, jscfg, tparams, jparams, tbatch, jbatch = _step_case(beta_ramp_epochs=ramp)
    jgates = jax.jit(lambda s: jstep.compute_losses(jscfg, jparams, jbatch, s, None)[1])
    state = create_train_state(tparams, 5e-4, "step", 4)
    # beta at step 8 (epoch 2), ramped over steps 8-14; car-reg at step 12
    betas = []
    for step in (0, 7, 8, 10, 11, 12, 13, 15):
        state.step = step
        state.feed()
        with torch.no_grad():
            _, got, _ = tstep.compute_losses(tscfg, tparams, tbatch, state.step_t)
        want = jgates(jnp.asarray(step, jnp.int32))
        keys = sorted(k for k in want if k.endswith("_activated"))
        assert keys == sorted(k for k in got if k.endswith("_activated")), step
        assert len(keys) == 4
        for k in keys:
            assert got[k].dtype == torch.float32
            assert float(got[k]) == float(want[k]), (step, k, float(got[k]), float(want[k]))
        betas.append(float(got["beta_loss_activated"]))
    inside = [b for b in betas if 0.0 < b < 1.0]  # steps 10-13 with the ramp
    assert betas[:2] == [0.0, 0.0] and betas[-1] == 1.0 and len(inside) == (4 if ramp else 0)


@pytest.mark.parametrize("scheduler", ["step", "exponential", "multistep", "cosine"])
def test_device_learning_rate_equals_the_jax_schedule(scheduler):
    from satnerf_torch.models.field import FieldConfig
    from satnerf_tpu.train.schedule import make_lr_schedule as jschedule

    params = tinit_params(torch.Generator().manual_seed(0),
                          FieldConfig(variant="rs_semantic", layers=2, feat=16, skips=()),
                          t_vocab=5, device="cpu")
    state = create_train_state(params, 5e-4, scheduler, steps_per_epoch=4, num_epochs=6)
    jsched = jschedule(5e-4, scheduler, 4, 6)
    for step in (0, 3, 4, 7, 8, 15, 16, 23, 24, 31, 32):
        state.step = step
        state.feed()
        got = state.optimizer.lr
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(np.float32(state.schedule(step)))
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        assert abs(float(got) - want) <= 1e-6 * want, (step, float(got), want)
        assert int(state.step_t) == step


def test_checkpoint_round_trip_keeps_the_optimizer_count(workspace, port_runs):
    src = port_runs[K]["state"]
    run_dp = workspace / "ckpt_round_trip"
    ckpt = CheckpointManager(str(run_dp))
    ckpt.save_last(src)
    raw = torch.load(ckpt.path("last"), map_location="cpu", weights_only=True)
    assert int(raw["optimizer"]["count"]) == STEPS and raw["step"] == STEPS

    fcfg = port_runs[K]["trainer"].pipeline.step_config(6, device="cpu").render.field
    fresh = create_train_state(tinit_params(torch.Generator().manual_seed(1), fcfg,
                                            t_vocab=port_runs[K]["trainer"].pipeline.t_vocab,
                                            device="cpu"), 5e-4)
    opt, so = fresh.optimizer, src.optimizer

    def tensors(o):
        return o.params + o.exp_avg + o.exp_avg_sq + [o.count, o.lr]

    ptrs = [t.data_ptr() for t in tensors(opt)]
    CheckpointManager(str(run_dp)).restore(fresh)
    assert [t.data_ptr() for t in tensors(opt)] == ptrs  # restored in place
    assert fresh.step == STEPS and int(opt.count) == STEPS
    assert all(torch.equal(a, b) for a, b in zip(tensors(opt), tensors(so)))

    # a torch.optim.Adam state (the layout of earlier checkpoints): its step
    # is the count
    ref = torch.optim.Adam(opt.params, lr=1e-3)
    for p in opt.params:
        p.grad = torch.ones_like(p)
    ref.step()
    ref.step()
    opt.load_state_dict(ref.state_dict())
    assert int(opt.count) == 2
    assert all(torch.equal(opt.exp_avg_sq[i], ref.state[p]["exp_avg_sq"])
               for i, p in enumerate(opt.params))
    with pytest.raises(ValueError, match="moments"):
        opt.load_state_dict(dict(raw["optimizer"], state={}))


class TestTraceWindowByBlocks:
    """``tests/test_aux.py``'s TraceCapture cases, the port's profiler in
    place of ``jax.profiler``."""

    def _capture(self, monkeypatch, tmp_path, start, n):
        monkeypatch.setenv("SATNERF_TORCH_PROFILE_DIR", str(tmp_path))
        return TraceCapture(start_step=start, n_steps=n)

    def test_per_step_window(self, monkeypatch, tmp_path):
        tc = self._capture(monkeypatch, tmp_path, start=2, n=3)
        for s in range(8):
            tc.step(s)
        win = json.load(open(tmp_path / "trace_window.json"))
        assert win["first_step"] == 2 and win["last_step"] == 4
        assert win["steps_per_dispatch"] == 1 and win["block_sizes"] == [1]

    def test_block_dispatch_window_records_block(self, monkeypatch, tmp_path):
        tc = self._capture(monkeypatch, tmp_path, start=10, n=4)
        for s in range(0, 32, 8):
            tc.step(s, block=8)
        win = json.load(open(tmp_path / "trace_window.json"))
        # block [8, 16) overlaps start 10: the trace covers [8, 16)
        assert win["first_step"] == 8 and win["last_step"] == 15
        assert win["steps_per_dispatch"] == 8 and win["block_sizes"] == [8]
        assert json.load(open(tmp_path / "trace.json"))["traceEvents"] is not None

    def test_close_flushes_open_window(self, monkeypatch, tmp_path):
        tc = self._capture(monkeypatch, tmp_path, start=0, n=100)
        tc.step(0, block=4)
        tc.step(4, block=1)
        tc.close()
        win = json.load(open(tmp_path / "trace_window.json"))
        assert (win["first_step"], win["last_step"]) == (0, 4)
        assert win["steps_per_dispatch"] == 4 and win["block_sizes"] == [1, 4]
