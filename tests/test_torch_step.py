"""satnerf_torch.train (step, state, schedule, configs) against the JAX
package: one training step from the same params and batch, deterministic
ladder (JAX ``key=None``, or ``perturb=0`` where ``grad_accum`` needs a
key), every ``loss_dict`` entry and the updated params.

Bars. Loss terms: 1e-5 of the value (f32 sums in another order). Updated
params: Adam's first update is lr * g / (|g| + 1e-8), so an element whose
gradient is within float noise of 0 can move by up to 2 lr either way in
the two packages; every other element agrees to 2e-5 (4% of one step at
lr 5e-4). So: every element within 2 lr, and at most 0.1% of the elements
of any tensor beyond 2e-5.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models.field import FieldConfig as JFieldConfig
from satnerf_tpu.render import renderer as jrender
from satnerf_tpu.train import step as jstep
from satnerf_tpu.train.state import TrainState as JTrainState
from satnerf_tpu.train.state import init_params as jinit_params
from satnerf_tpu.train.state import make_optimizer
from satnerf_torch.models.field import FieldConfig
from satnerf_torch.models.import_params import params_from_jax
from satnerf_torch.render import renderer as trender
from satnerf_torch.train import step as tstep
from satnerf_torch.train.state import create_train_state
from torch_parity import synthetic_rays

LR = 5e-4
N_SAMPLES = 16


def _batch(b=8, depth=4, seed=0):
    rays, extras = synthetic_rays(b, seed, vocab=5)
    rng = np.random.default_rng(seed + 1)
    out = {"rays": rays, "extras": extras,
           "rgbs": rng.uniform(0, 1, (b, 3)).astype(np.float32),
           "semantic": rng.integers(0, 5, (b, 1)).astype(np.int32),
           "semantic_sparsity_mask": rng.uniform(size=b) > 0.2}
    out["semantic"][0] = 4  # at least one car ray for the car-reg term
    if depth:
        out.update(depth_rays=rays[:depth], depth_extras=extras[:depth],
                   depth_depths=rng.uniform(0.5, 1.5, (depth,)).astype(np.float32),
                   depth_weights=rng.uniform(0.5, 1, (depth,)).astype(np.float32))
    return out


def _field_kw(variant, impl):
    if impl == "pallas":  # the fused path: feat_last a multiple of 128
        return dict(variant=variant, layers=3, feat=256, skips=(1,),
                    mapping=variant == "rs_semantic", trunk_impl="pallas")
    return dict(variant=variant, layers=3, feat=64, skips=(1,),
                mapping=variant == "rs_semantic")


def _one_step(variant="rs_semantic", impl="xla", depth=True, sc_stride=1,
              step=0, field_kw=None, jit=False, **step_kw):
    """(JAX metrics, port metrics, port state, JAX params in the port's
    layout) after one step of each package; ``field_kw`` replaces the
    field of ``_field_kw``, ``jit`` runs JAX's step under ``jax.jit``."""
    fkw = field_kw or _field_kw(variant, impl)
    jf, tf = JFieldConfig(**fkw), FieldConfig(**fkw)
    accum = step_kw.get("grad_accum", 1) > 1
    rkw = dict(n_samples=N_SAMPLES, sc_stride=sc_stride, perturb=0.0 if accum else 1.0)
    jr, tr = jrender.RenderConfig(field=jf, **rkw), trender.RenderConfig(field=tf, **rkw)
    skw = dict(steps_per_epoch=4, sc_lambda=0.05, first_beta_epoch=0, depth=depth,
               semantic=variant == "rs_semantic", car_index=4,
               use_car_reg_loss=variant == "rs_semantic", car_reg_loss_start=0)
    skw.update(step_kw)
    params = jinit_params(jax.random.PRNGKey(0), jf, t_vocab=5)
    batch = _batch(depth=4 if depth else 0)

    opt = make_optimizer(LR, "step", 4)
    # the schedule reads the optimizer's own step count, which a real run
    # keeps equal to state.step
    opt_state = opt.init(params)
    count = jnp.asarray(step, jnp.int32)
    opt_state = opt_state._replace(count=count, hyperparams_states={
        k: v._replace(count=count) for k, v in opt_state.hyperparams_states.items()})
    state = JTrainState(params=params, opt_state=opt_state,
                        step=jnp.asarray(step, jnp.int32))
    step_fn = jstep.build_train_step(jstep.StepConfig(render=jr, **skw), opt)
    with contextlib.nullcontext() if jit else jax.disable_jit():
        new_state, jm = (jax.jit(step_fn) if jit else step_fn)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(3) if accum else None)

    tparams = params_from_jax(jax.tree.map(np.asarray, params), tf, device="cpu")
    tstate = create_train_state(tparams, LR, "step", 4)
    tstate.step = step
    tstate, tm = tstep.build_train_step(tstep.StepConfig(render=tr, **skw))(
        tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    want = params_from_jax(jax.tree.map(np.asarray, new_state.params), tf, device="cpu")
    return jm, tm, tstate, want


def _check(jm, tm, tstate, want):
    assert set(tm) == set(jm)
    for k in jm:
        ref = float(jm[k])
        assert abs(float(tm[k]) - ref) <= 1e-5 * max(1.0, abs(ref)), k
    got = dict(tstate.params["field"].state_dict())
    ref = dict(want["field"].state_dict())
    got["t"], ref["t"] = tstate.params["t"].detach(), want["t"].detach()
    for k in ref:
        d = (got[k] - ref[k]).abs()
        assert float(d.max()) <= 2 * LR + 1e-6, k
        assert float((d > 2e-5).float().mean()) <= 1e-3, k


@pytest.mark.parametrize("case", [
    dict(variant="rs_semantic"),
    dict(variant="rs_semantic", depth=False),
    dict(variant="satnerf"),
    dict(variant="satnerf", depth=False),
    dict(variant="rs_semantic", use_beta_for_s=True),
    dict(variant="rs_semantic", sc_stride=2),
], ids=["rs_semantic", "rs_semantic-nodepth", "satnerf", "satnerf-nodepth",
        "beta_for_s", "sc_stride2"])
def test_one_step_matches_jax(case):
    _check(*_one_step(**case))
