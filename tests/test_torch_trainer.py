"""The port's training CLI, loop, checkpoints and resume on the CPU, at
``tests/test_e2e.py``'s size (2 train + 1 test view, 40 x 40, a 2 x 64
field, 8 samples, 40 steps), and the slice as a whole against the JAX
package: the port's ``best`` checkpoint loaded by the JAX package's
``params_from_lightning_ckpt`` renders the validation rays as the port does
(5e-5 abs on rgb, 1e-4 on depth) and gives the same DSM MAE (1e-3 m)."""

from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from satnerf_torch.configs import (
    MainConfig,
    RSSemanticConfig,
    RunConfig,
    load_configs_from_logs,
    write_toml,
)
from satnerf_torch.datasets.synthetic import generate_scene
from satnerf_torch.ops import composite as comp
from satnerf_torch.ops import field_fused as ff
from satnerf_torch.pipelines import load_pipeline
from satnerf_torch.run import resume_training, training
from satnerf_torch.train import checkpoint as ckpt_mod
from satnerf_torch.train.checkpoint import export_params, load_warm_start_params
from satnerf_torch.train.dispatch import step_seed
from satnerf_torch.train.loop import Trainer, val_chunk_rays
from satnerf_torch.train.state import init_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE = dict(n_samples=8, fc_layers=2, fc_units=64, fc_skips=[1], batch_size=256,
            render_chunk_size=4096, first_beta_epoch=1, depth_enabled=True,
            use_car_reg_loss=True, car_reg_loss_start=2)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    base = tmp_path_factory.mktemp("trainer")
    generate_scene(str(base / "datasets" / "SYN"), n_train=2, n_test=1, img_size=40,
                   n_tie_points=80)
    return base


def _run_dict(base, **kw):
    return dict(dict(dataset_name="SYN", datasets_dp=str(base / "datasets"),
                     cache_dp=str(base / "cache"), workspace_dp=str(base / "training"),
                     max_train_steps=40, check_val_every_n_epoch=1,
                     num_sanity_val_steps=1, seed=0), **kw)


def _trainer(base, log_every=50, pipe=None, **run):
    cfg = MainConfig(RunConfig(**_run_dict(base, **run)),
                     RSSemanticConfig(**dict(PIPE, **(pipe or {}))))
    pipeline = load_pipeline(cfg)
    pipeline.prepare_run()
    pipeline.load_datasets()
    return Trainer(pipeline, log_every=log_every, device="cpu")


def _same_params(a, b) -> float:
    pa, pb = export_params(a.params), export_params(b.params)
    assert set(pa) == set(pb)
    return max(float((pa[k] - pb[k]).abs().max()) for k in pa)


@pytest.fixture(scope="module")
def cli_run(workspace):
    """``python -m satnerf_torch.run.training start_training`` on the flagship
    TOML with small-size overrides, ``--device cpu``."""
    pipe_fp = workspace / "pipeline.toml"
    toml = open(os.path.join(REPO, "configs", "pipelines", "rs_semantic.toml")).read()
    body = [line for line in toml.splitlines() if line.split("=")[0].strip() not in PIPE]
    body += [f"{k} = {str(v).lower() if isinstance(v, bool) else v}" for k, v in PIPE.items()]
    pipe_fp.write_text("\n".join(body) + "\n")
    run_fp = workspace / "run.toml"
    write_toml(str(run_fp), _run_dict(workspace, save_every_n_epochs=1))
    ff.PLAIN_CALLS = comp.PLAIN_CALLS = 0
    pipeline, state, trainer = training.start_training(str(run_fp), str(pipe_fp),
                                                       device="cpu", log_every=10)
    return {"pipeline": pipeline, "state": state, "trainer": trainer,
            "run_fp": str(run_fp), "pipe_fp": str(pipe_fp),
            "composite_calls": comp.PLAIN_CALLS}


def test_cli_trains_and_writes_the_reference_run_layout(cli_run):
    state, trainer = cli_run["state"], cli_run["trainer"]
    run_dp = cli_run["pipeline"].cfg.run.run_dp
    assert state.step == 40
    for rel in ("configs/run.toml", "configs/pipeline.toml", "ckpoints/last.ckpt",
                "ckpoints/best.ckpt", "ckpoints/epoch_1.ckpt", "ckpoints/epoch_3.ckpt",
                "log.txt", "profiler/profiler.txt"):
        assert os.path.isfile(os.path.join(run_dp, rel)), rel
    dsm_dp = os.path.join(run_dp, "visualization", "train", "dsm")
    assert any(f.endswith(".tif") for f in os.listdir(dsm_dp))
    assert [h["step"] for h in trainer.history] == [10, 20, 30, 40]
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())
    val = trainer.val_history[-1]
    for k in ("train/psnr", "train/ssim_0", "train/mae", "test/psnr", "test/mae"):
        assert np.isfinite(val[k]), k
    assert val["train/ssim_0"] <= 1.0
    assert trainer.val_history[0]["sanity"] and "train/mae" not in trainer.val_history[0]
    # the depth drop (step 10) and the beta gate (epoch 1 = step 12) happened
    assert "depth_loss_activated" not in trainer.history[-1]
    assert trainer.history[-1]["beta_loss_activated"] == 1.0


def test_cli_composites_by_the_launch_schedule_chip_smoke_expects(cli_run):
    """K5's plain calls on the CPU follow the schedule that chip_smoke.py's
    train_scene phase holds the card's launches to: 2 per step until the
    depth drop, 1 after it, 1 per validation chunk."""
    trainer = cli_run["trainer"]
    drop = cli_run["pipeline"].ds_drop_step
    rgb_test = cli_run["pipeline"].datasets["rgb_test"]
    chunk = val_chunk_rays(trainer.cfg.pipeline)
    per_image = [-(-len(item["rays"]) // chunk) for item in rgb_test.data]
    chunks = sum(sum(per_image[:1] if v["sanity"] else per_image)
                 for v in trainer.val_history)
    assert cli_run["composite_calls"] == 2 * drop + (40 - drop) + chunks


def test_cli_without_a_gpu_raises_instead_of_running_on_the_cpu(cli_run):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        training.main(["start_training", cli_run["run_fp"], cli_run["pipe_fp"]])
    with pytest.raises(RuntimeError, match="CUDA"):
        resume_training.main(["resume", cli_run["pipeline"].cfg.run.run_dp])


def test_best_checkpoint_renders_through_the_jax_package(cli_run, tmp_path):
    """The slice end to end: the port's best params, read by the JAX package,
    render the validation rays as the port does, with the same DSM MAE."""
    from satnerf_tpu import configs as jconfigs
    from satnerf_tpu.eval.dsm import compute_dsm_and_mae as jdsm_mae
    from satnerf_tpu.models.import_torch import params_from_lightning_ckpt
    from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
    from satnerf_tpu.render.renderer import render_image_chunked as jrender
    from satnerf_tpu.train.step import step_config_from_main
    from satnerf_torch.eval.dsm import compute_dsm_and_mae
    from satnerf_torch.models.field import Field
    from satnerf_torch.models.import_params import load_lightning_ckpt
    from satnerf_torch.render.renderer import render_image_chunked

    pipeline = cli_run["pipeline"]
    run_dp = pipeline.cfg.run.run_dp
    best = os.path.join(run_dp, "ckpoints", "best.ckpt")
    jcfg = jconfigs.load_configs_from_logs(run_dp)
    jpipe = jload_pipeline(jcfg)
    jpipe.load_datasets()
    jscfg = step_config_from_main(jcfg, 12, with_depth=False, n_classes=5, car_index=4)
    jrcfg = dataclasses.replace(jscfg.render, solar_correction=False)
    jparams = params_from_lightning_ckpt(best, jrcfg.field, t_vocab=50)
    tparams = load_lightning_ckpt(best)
    trcfg = dataclasses.replace(pipeline.step_config(12, with_depth=False, device="cpu").render,
                                solar_correction=False)
    field = Field(trcfg.field)
    field.load_state_dict(tparams["field"])
    tp = {"field": field, "t": tparams["t"]}
    chunk = val_chunk_rays(pipeline.cfg.pipeline)
    for i in range(2):
        item = pipeline.datasets["rgb_test"].image_item(i)
        got = render_image_chunked(tp, trcfg, item["rays"], item["extras"], chunk=chunk,
                                   device="cpu")
        want = jrender(jparams, jrcfg, item["rays"], item["extras"], chunk=chunk)
        assert float(np.abs(got["rgb"] - np.asarray(want["rgb"])).max()) <= 5e-5
        assert float(np.abs(got["depth"] - np.asarray(want["depth"])).max()) <= 1e-4
        tm = compute_dsm_and_mae(pipeline.datasets["rgb_test"], item["rays"], got["depth"],
                                 str(tmp_path / "t"), item["name"], 0)
        jm = jdsm_mae(jpipe.datasets["rgb_test"], item["rays"], np.asarray(want["depth"]),
                      str(tmp_path / "j"), item["name"], 0)
        assert abs(float(tm["mean"]) - float(jm["mean"])) <= 1e-3
        # the validation that saved best rendered these very arrays
        ref = cli_run["trainer"].best_val_renders[item["name"]]
        np.testing.assert_array_equal(got["rgb"], ref["rgb"])


def test_configs_reload_from_the_run_logs(cli_run):
    cfg = cli_run["pipeline"].cfg
    again = load_configs_from_logs(cfg.run.run_dp)
    assert again.pipeline == cfg.pipeline
    assert again.run.run_dp == cfg.run.run_dp
    assert again.run == cfg.run


@pytest.fixture(scope="module")
def uninterrupted(workspace):
    trainer = _trainer(workspace, log_every=4, num_sanity_val_steps=0, max_train_steps=12)
    return trainer.fit(validate_every_epoch=False), trainer


def test_resume_equals_the_uninterrupted_run_bitwise(workspace, uninterrupted):
    state, trainer = uninterrupted
    first = _trainer(workspace, log_every=4, num_sanity_val_steps=0, max_train_steps=12)
    mid = first.fit(max_steps=7, validate_every_epoch=False)  # inside epoch 0, past the drop
    assert mid.step == 7
    cfg = first.cfg
    cfg.run.resume_from_ckpoint = True
    again = Trainer(first.pipeline, log_every=4, device="cpu")
    reads = []
    load = torch.load
    try:
        ckpt_mod.torch.load = lambda *a, **k: reads.append(a[0]) or load(*a, **k)
        resumed = again.fit(validate_every_epoch=False)
    finally:
        ckpt_mod.torch.load = load
    assert len(reads) == 1  # the checkpoint is read once
    assert resumed.step == 12
    assert _same_params(resumed, state) == 0.0
    assert again.history[-1] == trainer.history[-1]
    assert set(resumed.optimizer.state_dict()["state"]) == set(
        state.optimizer.state_dict()["state"])


def test_steps_per_dispatch_and_callbacks_leave_the_trajectory_unchanged(workspace,
                                                                         uninterrupted):
    """What the JAX package's ``test_steps_per_dispatch_invariance`` and
    ``test_step_callbacks_fire_at_exact_steps`` check: blocks of 4 steps per
    dispatch give the per-step run's trajectory exactly, and step callbacks
    fire at their exact steps (the blocks are cut to land on them; 99 is
    past the run's end)."""
    state, trainer = uninterrupted
    seen = []
    blocks = _trainer(workspace, log_every=4, num_sanity_val_steps=0, max_train_steps=12,
                      steps_per_dispatch=4)
    assert blocks.cfg.run.steps_per_dispatch == 4
    got = blocks.fit(validate_every_epoch=False,
                     step_callbacks={5: lambda s, i: seen.append((i, s.step)),
                                     7: lambda s, i: seen.append((i, s.step)),
                                     99: lambda s, i: seen.append(i)})
    assert seen == [(5, 5), (7, 7)]
    assert got.step == 12
    assert _same_params(got, state) == 0.0
    assert [h["loss"] for h in blocks.history] == [h["loss"] for h in trainer.history]
    # steps 0-7 one a dispatch (the depth drop at 3, log step 4, callbacks at
    # 5 and 7, log step 8), then one block of 4
    assert blocks.profiler.counts["train_step"] == 9


def test_sigterm_checkpoints_and_the_run_resumes(workspace, uninterrupted):
    state, _ = uninterrupted
    first = _trainer(workspace, log_every=4, num_sanity_val_steps=0, max_train_steps=12)
    stopped = first.fit(validate_every_epoch=False, step_callbacks={
        5: lambda s, i: os.kill(os.getpid(), signal.SIGTERM)})
    assert stopped.step == 5
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL or callable(
        signal.getsignal(signal.SIGTERM))
    raw = torch.load(os.path.join(first.cfg.run.run_dp, "ckpoints", "last.ckpt"),
                     weights_only=True)
    assert raw["step"] == 5 and "optimizer" in raw
    resumed = resume_training.prepare_resume(first.cfg.run.run_dp, device="cpu",
                                             log_every=4)
    final = resumed.fit(validate_every_epoch=False)
    assert final.step == 12
    assert _same_params(final, state) == 0.0


def test_resume_from_a_params_only_checkpoint_raises(cli_run):
    cfg = cli_run["pipeline"].cfg
    trainer = Trainer(cli_run["pipeline"], device="cpu")
    cfg.run.resume_from_ckpoint = True
    cfg.run.ckpoint_fp = os.path.join(cfg.run.run_dp, "ckpoints", "best.ckpt")
    try:
        with pytest.raises(ValueError, match="params-only"):
            trainer.fit(validate_every_epoch=False)
    finally:
        cfg.run.resume_from_ckpoint = False
        cfg.run.ckpoint_fp = None


def test_warm_start_seeds_the_fine_field_from_the_coarse_one(cli_run):
    from satnerf_torch.models.field import FieldConfig

    best = os.path.join(cli_run["pipeline"].cfg.run.run_dp, "ckpoints", "best.ckpt")
    src = ckpt_mod.torch.load(best, weights_only=True)["state_dict"]
    fcfg = cli_run["pipeline"].step_config(12, device="cpu").render.field
    assert isinstance(fcfg, FieldConfig)
    params = init_params(torch.Generator().manual_seed(1), fcfg, 50, device="cpu",
                         use_fine_network=True)
    load_warm_start_params(params, best)
    out = export_params(params)
    for k, v in src.items():
        torch.testing.assert_close(out[k], v, rtol=0, atol=0)
        if k.startswith("model_coarse."):
            fine = "model_fine." + k[len("model_coarse."):]
            torch.testing.assert_close(out[fine], v, rtol=0, atol=0)


def test_warm_start_run_starts_from_the_checkpoint_params(workspace, cli_run):
    best = os.path.join(cli_run["pipeline"].cfg.run.run_dp, "ckpoints", "best.ckpt")
    trainer = _trainer(workspace, num_sanity_val_steps=0, warm_start_fp=best)
    state = trainer.fit(max_steps=1, validate_every_epoch=False)
    assert state.step == 1
    src = torch.load(best, weights_only=True)["state_dict"]
    moved = max(float((export_params(state.params)[k] - v).abs().max())
                for k, v in src.items())
    assert 0.0 < moved <= 10 * 5e-4  # one Adam step (lr 5e-4) from the checkpoint


def test_data_parallel_is_not_ported_yet(workspace):
    """Data parallelism is ported (``tests/test_torch_parallel.py``); what
    this test holds now: ``data_parallel=2`` with a batch that does not
    divide over the ranks fails as in the JAX package, with its message,
    before any process group is needed."""
    from satnerf_tpu import configs as jconfigs
    from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
    from satnerf_tpu.train.loop import Trainer as JTrainer

    msg = "batch_size 255 must divide over 2 devices"
    trainer = _trainer(workspace, data_parallel=2, pipe=dict(batch_size=255))
    with pytest.raises(ValueError, match=msg):
        trainer.fit()
    jcfg = jconfigs.MainConfig(
        run=jconfigs.RunConfig(**_run_dict(workspace, data_parallel=2,
                                           cache_dp=str(workspace / "jcache"))),
        pipeline=jconfigs.RSSemanticConfig(**dict(PIPE, batch_size=255)))
    jpipe = jload_pipeline(jcfg)
    jpipe.prepare_run()
    with pytest.raises(AssertionError, match=msg):
        JTrainer(jpipe).fit()


def test_val_chunk_counts_every_point_of_a_hierarchical_ray():
    """The reference divides the points-per-chunk knob by ``n_samples`` alone;
    the port divides by the points a ray evaluates with a fine network
    (2 * n_samples + n_importance) and scales the 8,192-16,384 ray floor and
    cap by the same ratio. Without a fine network it is the reference's."""
    from satnerf_tpu.train.loop import val_chunk_rays as jval_chunk_rays

    for kw in (dict(), dict(render_chunk_size=12000 * 64), dict(render_chunk_size=1 << 30),
               dict(val_chunk_rays=2048), dict(n_importance=64)):
        p = RSSemanticConfig(**kw)
        assert val_chunk_rays(p) == jval_chunk_rays(p, p.n_samples)
    hier = RSSemanticConfig(n_samples=64, n_importance=128, use_fine_network=True)
    assert val_chunk_rays(hier) == 8192 * 64 // 256
    big = RSSemanticConfig(n_samples=64, n_importance=128, use_fine_network=True,
                           render_chunk_size=3000 * 256)
    assert val_chunk_rays(big) == 3000
    assert val_chunk_rays(RSSemanticConfig(use_fine_network=True, val_chunk_rays=512)) == 512


def test_step_seed_is_a_fixed_rule():
    assert step_seed(0, 5) == step_seed(0, 5)
    seeds = {step_seed(s, i) for s in (0, 1, 42) for i in range(200)}
    assert len(seeds) == 600 and all(0 <= s < 2**63 for s in seeds)


def test_trace_capture_writes_a_chrome_trace_of_its_window(tmp_path, monkeypatch):
    import json

    from satnerf_torch.train.profiling import TraceCapture

    monkeypatch.setenv("SATNERF_TORCH_PROFILE_DIR", str(tmp_path))
    trace = TraceCapture(start_step=2, n_steps=2)
    for step in range(6):
        trace.step(step)
        torch.ones(8).sum()
    trace.close()
    with open(tmp_path / "trace_window.json") as f:
        assert json.load(f) == {"first_step": 2, "last_step": 3, "steps_per_dispatch": 1,
                                "block_sizes": [1]}
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
