"""Data-parallel cases of ``tests/test_torch_parallel.py``, and the program
each of its two gloo ranks runs:

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dp_case.py OUT_DP RUN_TOML PIPELINE_TOML

Each rank (1) takes one flagship-layout training step on ``step_case``'s
global batch, whose two halves hold different numbers of masked rays and of
car rays, and keeps the all-reduced gradients Adam stepped with
(``record_grads``), (2) renders ``render_case``'s rays through
``render_image_sharded``, (3) trains the run of RUN_TOML (``data_parallel =
2``) until rank 1 alone asks to stop at STOP_STEP, and writes what it got
under OUT_DP. It imports no JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from satnerf_torch.configs import load_configs, load_pipeline_toml, step_config_from_pipeline  # noqa: E402
from satnerf_torch.train.state import create_train_state, init_params, trainable  # noqa: E402

SMALL = dict(n_samples=8, fc_layers=2, fc_units=64, fc_skips=[1])
# every loss term on from step 0: beta and car-reg gates open, beta for the
# semantic loss, depth supervision, solar correction
STEP_PIPE = dict(SMALL, first_beta_epoch=0, use_beta_for_s=True, use_car_reg_loss=True,
                 car_reg_loss_start=0)
N_RAYS, N_DEPTH, N_CLASSES, CAR = 64, 32, 5, 4
STOP_STEP = 6
GRAD_ACCUM = (1, 2)
STEP_SEED = 7


def step_case(grad_accum: int = 1):
    """-> (step config, fresh train state, global batch) on the CPU. Rank 0's
    half of the batch has 24 of 32 rays masked out of the semantic loss and
    2 car rays; rank 1's half has none masked and 12 car rays. With
    ``grad_accum`` K the micro-batches are the global batch's K slices,
    each split over the ranks."""
    p = dict(load_pipeline_toml(os.path.join(REPO, "configs", "pipelines",
                                             "rs_semantic.toml")), **STEP_PIPE,
             grad_accum=grad_accum)
    scfg = step_config_from_pipeline(p, 1, with_depth=True, n_classes=N_CLASSES,
                                     car_index=CAR, device="cpu")
    params = init_params(torch.Generator().manual_seed(0), scfg.render.field, t_vocab=5,
                         device="cpu")
    state = create_train_state(params, 5e-4, "step", 1, 1)
    rng = np.random.default_rng(3)
    rays, extras = _rays(N_RAYS, rng)
    d_rays, d_extras = _rays(N_DEPTH, rng)
    half = N_RAYS // 2
    labels = rng.integers(0, CAR, N_RAYS)
    labels[rng.choice(half, 2, replace=False)] = CAR
    labels[half + rng.choice(half, 12, replace=False)] = CAR
    mask = np.ones(N_RAYS, bool)
    mask[rng.choice(half, 24, replace=False)] = False
    batch = {
        "rays": rays, "extras": extras,
        "rgbs": rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
        "semantic": labels.astype(np.int32)[:, None],
        "semantic_sparsity_mask": mask,
        "depth_rays": d_rays, "depth_extras": d_extras,
        "depth_depths": rng.uniform(0.8, 1.2, (N_DEPTH, 1)).astype(np.float32),
        "depth_weights": rng.uniform(0.5, 1.0, (N_DEPTH, 1)).astype(np.float32),
    }
    return scfg, state, {k: torch.from_numpy(v) for k, v in batch.items()}


def trainable_names(params: dict) -> list:
    """The names of ``export_params`` for ``trainable(params)``, in its order."""
    names = [f"model_coarse.{n}" for n, _ in params["field"].named_parameters()]
    if params.get("fine") is not None:
        names += [f"model_fine.{n}" for n, _ in params["fine"].named_parameters()]
    return names + [f"model_{k}.weight" for k in ("t", "t_s") if params.get(k) is not None]


def record_grads(state) -> dict:
    """-> a dict that the next ``state.optimizer.step()`` fills with copies of
    the gradients it steps with ({name: grad}): after the all-reduce and the
    1/K of ``grad_accum``, before Adam."""
    got = {}
    names, leaves = trainable_names(state.params), trainable(state.params)

    step = state.optimizer.step

    def keep():
        got.update({n: p.grad.detach().clone() for n, p in zip(names, leaves)})
        step()

    state.optimizer.step = keep
    return got


def _rays(n: int, rng):
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), np.ones((n, 1))], 1)
    d = np.concatenate([rng.uniform(-0.15, 0.15, (n, 2)), -np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.zeros((n, 1)), np.full((n, 1), 2.0)], 1)
    sun = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.full((n, 1), 0.8)], 1)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    extras = np.concatenate([sun, rng.integers(0, 5, (n, 1))], 1)
    return rays.astype(np.float32), extras.astype(np.float32)


def render_case():
    """-> (params, render config, rays, extras): 100 rays, not a multiple of
    the ranks' chunk rows, rendered in 64-ray chunks."""
    scfg, state, _ = step_case()
    rng = np.random.default_rng(5)
    rays, extras = _rays(100, rng)
    from dataclasses import replace

    return state.params, replace(scfg.render, solar_correction=False), rays, extras


def main(out_dp: str, run_fp: str, pipe_fp: str) -> int:
    from satnerf_torch.parallel import local_batch_slice, make_mesh, process_group, replicated
    from satnerf_torch.render.renderer import render_image_sharded
    from satnerf_torch.run.training import prepare_trainer
    from satnerf_torch.train.checkpoint import export_params
    from satnerf_torch.train.step import build_train_step

    torch.set_num_threads(2)
    with process_group(2, "gloo"):
        layout = make_mesh(2)
        rank = layout.rank
        try:
            local_batch_slice(N_RAYS - 1)
        except ValueError as exc:
            odd_batch = str(exc)
        for k in GRAD_ACCUM:
            scfg, state, batch = step_case(k)
            replicated(state.params, layout)
            grads = record_grads(state)
            state, metrics = build_train_step(scfg, layout)(
                state, batch, torch.Generator().manual_seed(STEP_SEED))
            torch.save({"metrics": {k: v.item() for k, v in metrics.items()},
                        "params": export_params(state.params), "grads": grads,
                        "local_batch": local_batch_slice(N_RAYS), "odd_batch": odd_batch},
                       os.path.join(out_dp, f"step_rank{rank}_k{k}.pt"))

        params, rcfg, rays, extras = render_case()
        res = render_image_sharded(params, rcfg, rays, extras, layout, chunk=64,
                                   device="cpu")
        np.savez(os.path.join(out_dp, f"render_rank{rank}.npz"), **res)

        trainer = prepare_trainer(load_configs(run_fp, pipe_fp), "cpu", log_every=1)
        callbacks = {STOP_STEP: lambda s, i: trainer.request_stop()} if rank == 1 else {}
        state = trainer.fit(step_callbacks=callbacks)
        torch.save({"step": state.step, "run_dp": trainer.cfg.run.run_dp,
                    "losses": [h["loss"] for h in trainer.history]},
                   os.path.join(out_dp, f"fit_rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:]))
