"""Data parallelism of the port (``satnerf_torch/parallel``) on the CPU: two
gloo ranks, each a process (``tests/torch_dp_case.py``) on a free localhost
port, against one process of the port.

* One flagship-layout step (every loss term on, a 2 x 64 field) whose two
  shards hold different numbers of masked rays and of car rays, also with
  ``grad_accum`` 2 (the global batch's micro-batches), checked for what data
  parallelism changes, the order in which the gradient is summed: the loss
  within rtol 2e-5 and the first trunk layer's weight within 1e-6 of one
  process (the JAX package's bars for its sharded step,
  ``tests/test_parallel.py``); every all-reduced gradient within
  ``TOL_GRAD`` of its largest one-process component; the two ranks'
  parameters bitwise equal; and the one-process Adam, applied to rank 0's
  gradient, giving rank 0's parameters bit for bit. (Adam's first step
  lr * g / (|g| + 1e-8) turns the rounding of a sum over two ranks into a
  parameter difference of up to lr for the components near 1e-8, so a bar
  on every parameter after the step measures that rounding, not the data
  parallelism.)
* The fault those bars guard against: averaging the two shards' own losses
  misses the one-process loss by more than rtol 2e-5.
* A sharded validation render against the single one (1e-5, labels equal).
* ``Trainer.fit`` with ``data_parallel = 2``, stopped by a request on rank 1
  alone (both ranks stop before the same step), then resumed through the
  resume CLI, which starts its own two ranks: the parameters of one
  uninterrupted process within 1e-6.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from satnerf_torch.configs import write_toml
from satnerf_torch.datasets.synthetic import generate_scene
from satnerf_torch.parallel.multihost import free_port
from satnerf_torch.render.renderer import render_image_chunked
from satnerf_torch.run import training
from satnerf_torch.train.checkpoint import export_params
from satnerf_torch.train.step import build_train_step, compute_losses
from satnerf_torch.train.state import trainable
from torch_dp_case import (GRAD_ACCUM, STEP_SEED, STOP_STEP, record_grads, render_case,
                           step_case, trainable_names)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOSS, TOL_PARAM = 2e-5, 1e-6  # tests/test_parallel.py
# all-reduced against one-process gradients, max |dg| / max |g| per tensor:
# measured 4.9e-7 (grad_accum 1) and 4.1e-7 (2) in runs alone, up to 3.7e-6
# in a run beside six busy processes
TOL_GRAD = 1e-5
FIRST_TRUNK_W = "model_coarse.fc_net.0.weight"  # tests/test_parallel.py:58 trunk[0].w
FIT_PIPE = dict(n_samples=8, fc_layers=2, fc_units=64, fc_skips=[1], batch_size=256,
                render_chunk_size=4096, first_beta_epoch=0, depth_enabled=True,
                use_car_reg_loss=True, car_reg_loss_start=0)
FIT_STEPS = 12


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _write_run(base, name: str, data_parallel: int) -> str:
    fp = str(base / name)
    write_toml(fp, dict(dataset_name="SYN", datasets_dp=str(base / "datasets"),
                        cache_dp=str(base / f"cache{data_parallel}"),
                        workspace_dp=str(base / f"training{data_parallel}"),
                        max_train_steps=FIT_STEPS, num_sanity_val_steps=1, seed=0,
                        data_parallel=data_parallel))
    return fp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks of ``torch_dp_case.main`` run to their end -> what they
    wrote, with the scene and configs."""
    base = tmp_path_factory.mktemp("dp")
    generate_scene(str(base / "datasets" / "SYN"), n_train=2, n_test=1, img_size=40,
                   n_tie_points=80)
    toml = open(os.path.join(REPO, "configs", "pipelines", "rs_semantic.toml")).read()
    body = [ln for ln in toml.splitlines() if ln.split("=")[0].strip() not in FIT_PIPE]
    body += [f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
             for k, v in FIT_PIPE.items()]
    pipe_fp = base / "pipeline.toml"
    pipe_fp.write_text("\n".join(body) + "\n")
    run2 = _write_run(base, "run2.toml", 2)
    out = base / "out"
    out.mkdir()
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dp_case.py"), str(out), run2,
         str(pipe_fp)], cwd=REPO,
        env=dict(_env(), RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    return {"base": base, "out": out, "pipe_fp": str(pipe_fp)}


@pytest.mark.parametrize("grad_accum", GRAD_ACCUM)
def test_two_ranks_step_matches_one_process(ranks, grad_accum):
    scfg, state, batch = step_case(grad_accum)
    want_grads = record_grads(state)
    state, metrics = build_train_step(scfg)(state, batch,
                                            torch.Generator().manual_seed(STEP_SEED))
    want = export_params(state.params)
    got = [torch.load(ranks["out"] / f"step_rank{r}_k{grad_accum}.pt", weights_only=True)
           for r in range(2)]
    for g in got:
        assert set(g["metrics"]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(g["metrics"][k], v.item(), rtol=TOL_LOSS,
                                       atol=1e-7, err_msg=k)
        assert set(g["grads"]) == set(want_grads) and set(g["params"]) == set(want)
        for k, v in want_grads.items():  # the all-reduce sums what one process sums
            err = float((g["grads"][k] - v).abs().max())
            assert err <= TOL_GRAD * float(v.abs().max()), (k, err)
        torch.testing.assert_close(g["params"][FIRST_TRUNK_W], want[FIRST_TRUNK_W], rtol=0,
                                   atol=TOL_PARAM)
        assert g["local_batch"] == 32
        assert g["odd_batch"] == ("global batch 63 is not divisible by the pod's 2 devices "
                                  "(realized batch would be 62)")
    for k in want:  # both ranks step with the same gradient: replicas stay equal
        assert torch.equal(got[0]["params"][k], got[1]["params"][k]), k
    # the one-process optimizer on rank 0's gradient: rank 0's step, exactly
    _, replay, _ = step_case(grad_accum)
    for name, p in zip(trainable_names(replay.params), trainable(replay.params)):
        p.grad = got[0]["grads"][name].clone()
    replay.feed()
    replay.optimizer.step()
    for k, v in export_params(replay.params).items():
        assert torch.equal(v, got[0]["params"][k]), k
    for k in ("coarse_semantic", "coarse_car_reg_loss", "coarse_ds", "coarse_sc_term2"):
        assert metrics[k].item() != 0.0, k  # every term the shards split is on


def test_averaging_per_rank_losses_misses_the_bar():
    """What a step that averaged each shard's own loss would report (both
    halves rendered without jitter, so only the reduction differs)."""
    scfg, state, batch = step_case()
    n, nd = batch["rays"].shape[0], batch["depth_rays"].shape[0]
    halves = [{k: v[: (n if not k.startswith("depth_") else nd) // 2] for k, v in
               batch.items()},
              {k: v[(n if not k.startswith("depth_") else nd) // 2:] for k, v in
               batch.items()}]
    with torch.no_grad():
        whole = compute_losses(scfg, state.params, batch, 0)
        parts = [compute_losses(scfg, state.params, h, 0) for h in halves]
    averaged = 0.5 * (parts[0][0] + parts[1][0])
    assert abs(averaged.item() - whole[0].item()) > TOL_LOSS * abs(whole[0].item())
    for k in ("coarse_semantic", "coarse_car_reg_loss"):
        avg = 0.5 * (parts[0][1][k] + parts[1][1][k])
        assert abs(avg.item() - whole[1][k].item()) > TOL_LOSS * abs(whole[1][k].item()), k


def test_sharded_render_matches_the_single_one(ranks):
    params, rcfg, rays, extras = render_case()
    single = render_image_chunked(params, rcfg, rays, extras, chunk=64, device="cpu")
    for r in range(2):
        got = np.load(ranks["out"] / f"render_rank{r}.npz")
        assert set(got.files) == set(single)
        assert got["rgb"].shape == (100, 3)
        np.testing.assert_array_equal(got["semantic_label"], single["semantic_label"])
        for k in single:
            np.testing.assert_allclose(got[k], single[k], rtol=0, atol=1e-5, err_msg=k)


def test_two_rank_fit_stops_together_and_resumes_as_one_process(ranks):
    base = ranks["base"]
    fits = [torch.load(ranks["out"] / f"fit_rank{r}.pt", weights_only=True)
            for r in range(2)]
    assert [f["step"] for f in fits] == [STOP_STEP, STOP_STEP]
    assert fits[0]["run_dp"] == fits[1]["run_dp"]
    assert fits[0]["losses"] == fits[1]["losses"]
    run_dp = fits[0]["run_dp"]
    rc = subprocess.run([sys.executable, "-m", "satnerf_torch.run.resume_training",
                         "resume", run_dp, "--device", "cpu", "--dist-backend", "gloo"],
                        cwd=REPO, env=_env(), timeout=240).returncode
    assert rc == 0
    _, state, trainer = training.start_training(_write_run(base, "run1.toml", 1),
                                                ranks["pipe_fp"], device="cpu",
                                                log_every=1)
    assert state.step == FIT_STEPS
    np.testing.assert_allclose(fits[0]["losses"],
                               [h["loss"] for h in trainer.history[:STOP_STEP]],
                               rtol=TOL_LOSS)
    got = torch.load(os.path.join(run_dp, "ckpoints", "last.ckpt"), weights_only=True)
    assert got["step"] == FIT_STEPS
    for k, v in export_params(state.params).items():
        torch.testing.assert_close(got["state_dict"][k], v, rtol=0, atol=TOL_PARAM)
    # rank 0 wrote the validation's visualizers and DSMs, once
    viz = os.path.join(run_dp, "visualization", "test")
    assert {"rgb", "depth", "alts", "semantic_rendering", "dsm"} <= set(os.listdir(viz))
    assert len(os.listdir(os.path.join(viz, "rgb"))) == 1
