"""One training step of the RS-Semantic ablation fields through the port's
trunk-only kernel path (K3 forward, K4 backward; their plain versions on the
CPU) against the same step in the JAX package (its Pallas trunk in interpret
mode), with the helpers and bars of tests/test_torch_step.py: every loss
term within 1e-5 of its value, every updated parameter within 2 lr and at
most 0.1% of any tensor beyond 2e-5.

- ``use_separate_beta_for_s`` with ``use_beta_for_s``: the ``beta_s`` head
  feeds the semantic uncertainty loss (and its ``logbeta`` term);
- ``use_tj_instead_of_beta``: the rgb head reads the t embedding.
"""

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
from satnerf_torch.models.field import FieldConfig, use_fused_trunk
from satnerf_torch.models.import_params import params_from_jax
from satnerf_torch.ops import trunk as ttrunk
from satnerf_torch.render import renderer as trender
from satnerf_torch.train import step as tstep
from satnerf_torch.train.state import create_train_state
from test_torch_step import LR, N_SAMPLES, _batch, _check

FIELD = dict(variant="rs_semantic", layers=3, feat=128, skips=(1,), mapping=True,
             trunk_impl="pallas")
CASES = {
    "beta_s": (dict(use_separate_beta_for_s=True), dict(use_beta_for_s=True)),
    "beta_s_stored": (dict(use_separate_beta_for_s=True, trunk_bwd="stored"),
                      dict(use_beta_for_s=True)),
    "tj_instead_of_beta": (dict(use_tj_instead_of_beta=True), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ablation_step_through_k3_matches_jax(case):
    fkw, step_kw = CASES[case]
    jf, tf = JFieldConfig(**FIELD, **fkw), FieldConfig(**FIELD, **fkw)
    assert use_fused_trunk(tf)
    rkw = dict(n_samples=N_SAMPLES, sc_stride=2, perturb=1.0)
    skw = dict(steps_per_epoch=4, sc_lambda=0.05, first_beta_epoch=0, depth=True,
               semantic=True, car_index=4, use_car_reg_loss=True, car_reg_loss_start=0,
               **step_kw)
    params = jinit_params(jax.random.PRNGKey(0), jf, t_vocab=5)
    batch = _batch(depth=4)
    opt = make_optimizer(LR, "step", 4)
    state = JTrainState(params=params, opt_state=opt.init(params),
                        step=jnp.asarray(0, jnp.int32))
    with jax.disable_jit():
        new_state, jm = jstep.build_train_step(
            jstep.StepConfig(render=jrender.RenderConfig(field=jf, **rkw), **skw), opt)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, None)

    tparams = params_from_jax(jax.tree.map(np.asarray, params), tf, device="cpu")
    tstate = create_train_state(tparams, LR, "step", 4)
    before = (ttrunk.FWD_PLAIN_CALLS, ttrunk.PLAIN_CALLS)
    tstate, tm = tstep.build_train_step(
        tstep.StepConfig(render=trender.RenderConfig(field=tf, **rkw), **skw))(
        tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    # one trunk call and one trunk backward per render (main and depth)
    assert (ttrunk.FWD_PLAIN_CALLS, ttrunk.PLAIN_CALLS) == (before[0] + 2, before[1] + 2)
    if "beta_s" in case:
        assert "coarse_semantic_logbeta" in tm
    want = params_from_jax(jax.tree.map(np.asarray, new_state.params), tf, device="cpu")
    _check(jm, tm, tstate, want)
