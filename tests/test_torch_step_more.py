"""More of satnerf_torch.train against the JAX package (the helpers and bars
of tests/test_torch_step.py): ``grad_accum``, the epoch gates, the LR
schedules, the pipeline-TOML step config, and the stratified render's
gradients with the same jitter on both sides.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.configs import PIPELINE_REGISTRY, read_toml
from satnerf_tpu.models.field import FieldConfig as JFieldConfig
from satnerf_tpu.render import renderer as jrender
from satnerf_tpu.train import step as jstep
from satnerf_tpu.train.schedule import make_lr_schedule as jsched
from satnerf_tpu.train.state import init_params as jinit_params
from satnerf_torch.configs import load_pipeline_toml, step_config_from_pipeline
from satnerf_torch.models.field import FieldConfig
from satnerf_torch.models.import_params import field_state_from_params, params_from_jax
from satnerf_torch.render import renderer as trender
from satnerf_torch.train import step as tstep
from satnerf_torch.train.schedule import make_lr_schedule
from satnerf_torch.train.state import init_params
from test_torch_step import _check, _one_step
from torch_parity import synthetic_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_grad_accum_matches_jax():
    _check(*_one_step(variant="rs_semantic", grad_accum=2))


def test_gates_flip_with_the_epoch():
    # epoch 2 (step 8, 4 steps an epoch): beta on, car-reg not yet
    jm, tm, tstate, want = _one_step(variant="rs_semantic", depth=False, step=8,
                                     first_beta_epoch=2, car_reg_loss_start=3)
    assert float(tm["beta_loss_activated"]) == 1.0
    assert float(tm["car_reg_loss_activated"]) == 0.0
    assert float(tm["coarse_car_reg_loss"]) == 0.0
    _check(jm, tm, tstate, want)
    jm, tm, *_ = _one_step(variant="satnerf", depth=False, step=7, first_beta_epoch=2)
    assert float(tm["beta_loss_activated"]) == 0.0 == float(jm["beta_loss_activated"])
    assert float(tm["coarse_logbeta"]) == 0.0


def test_beta_ramp_matches_jax():
    scfg = dict(first_beta_epoch=1, beta_ramp_epochs=2.0)
    jm, tm, tstate, want = _one_step(variant="satnerf", depth=False, step=6, **scfg)
    assert abs(float(tm["beta_loss_activated"]) - 0.25) < 1e-7
    _check(jm, tm, tstate, want)


@pytest.mark.parametrize("name", ["step", "exponential", "multistep", "cosine"])
def test_lr_schedules_match_jax(name):
    ref, got = jsched(5e-4, name, 7, 20), make_lr_schedule(5e-4, name, 7, 20)
    for step in (0, 6, 7, 13, 14, 30, 63, 70, 200):
        assert abs(got(step) - float(ref(step))) <= 1e-12 + 1e-6 * float(ref(step)), step


def test_schedule_rejects_unknown_names():
    with pytest.raises(ValueError):
        make_lr_schedule(1e-3, "linear")


@pytest.mark.parametrize("pipeline", ["nerf", "snerf", "satnerf", "rs_semantic"])
def test_step_config_from_pipeline_mirrors_the_reference(pipeline):
    fp = os.path.join(REPO, "configs", "pipelines", f"{pipeline}.toml")
    p = load_pipeline_toml(fp)
    got = step_config_from_pipeline(p, steps_per_epoch=10, n_classes=5, car_index=4,
                                    device="cpu")
    cls = PIPELINE_REGISTRY[p["pipeline"]]
    jp = cls(**{k: v for k, v in read_toml(fp).items() if k in cls.model_fields})
    ref = jstep.step_config_from_main(types.SimpleNamespace(pipeline=jp), 10,
                                      n_classes=5, car_index=4)
    for f in dataclasses.fields(ref):
        if f.name != "render":
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    for f in ("n_samples", "solar_correction", "sc_stride", "compute_dtype"):
        assert getattr(got.render, f) == getattr(ref.render, f), f
    for f in ("variant", "layers", "feat", "skips", "mapping", "trunk_bwd"):
        assert getattr(got.render.field, f) == getattr(ref.render.field, f), f


def test_tj_instead_of_beta_disables_the_uncertainty_losses():
    p = load_pipeline_toml(os.path.join(REPO, "configs", "pipelines", "rs_semantic.toml"))
    p.update(use_tj_instead_of_beta=True, trunk_bwd="auto")
    got = step_config_from_pipeline(p, 10, device="cpu")
    assert got.first_beta_epoch == 10_000_000
    assert got.render.field.trunk_bwd == "recompute"


def test_init_params_makes_trainable_tables():
    cfg = FieldConfig(variant="rs_semantic", layers=2, feat=64, skips=(1,),
                      use_separate_tj_for_semantic=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, t_vocab=7, device="cpu")
    assert p["t"].shape == (7, 4) and p["t"].requires_grad and p["t"].is_leaf
    assert p["t_s"].requires_grad and p["t_s"].is_leaf
    with pytest.raises(RuntimeError):  # entry points default to the card
        if not torch.cuda.is_available():
            init_params(None, cfg)


def test_stratified_render_grads_match_jax_with_the_same_jitter():
    """The jittered ladder built once in numpy, fed to both renderers through
    ``given_z_vals``; gradients of rgb/depth/semantic sums wrt every field
    parameter and the t table (1e-4 of each tensor's largest gradient: the
    layer-by-layer engines on both sides)."""
    kw = dict(variant="rs_semantic", layers=3, feat=64, skips=(1,), mapping=True)
    jf, tf = JFieldConfig(**kw), FieldConfig(**kw)
    b, s = 6, 16
    rays, extras = synthetic_rays(b, 2, vocab=5)
    rng = np.random.default_rng(4)
    steps = np.arange(s, dtype=np.float32) * np.float32(1.0 / (s - 1))
    z = rays[:, 6:7] * (1 - steps) + rays[:, 7:8] * steps
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    upper = np.concatenate([mid, z[:, -1:]], 1)
    lower = np.concatenate([z[:, :1], mid], 1)
    z = (lower + (upper - lower) * rng.uniform(size=(b, s))).astype(np.float32)
    params = jinit_params(jax.random.PRNGKey(1), jf, t_vocab=5)

    def jloss(p):
        r = jrender.render_rays(p, jrender.RenderConfig(field=jf, n_samples=s),
                                jnp.asarray(rays), jnp.asarray(extras),
                                given_z_vals=jnp.asarray(z))
        return (jnp.sum(r["rgb"]) + jnp.sum(r["depth"]) + jnp.sum(r["semantic_logits"])
                + jnp.sum(r["sun_sc"]) + jnp.sum(r["beta"]))

    gj = jax.tree.map(np.asarray, jax.grad(jloss)(params))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tf, device="cpu")
    r = trender.render_rays(tp, trender.RenderConfig(field=tf, n_samples=s),
                            torch.from_numpy(rays), torch.from_numpy(extras),
                            given_z_vals=torch.from_numpy(z))
    (r["rgb"].sum() + r["depth"].sum() + r["semantic_logits"].sum()
     + r["sun_sc"].sum() + r["beta"].sum()).backward()
    want = field_state_from_params(gj["field"])
    want["t"] = torch.from_numpy(np.array(gj["t"]))
    got = {k: p.grad for k, p in tp["field"].named_parameters()}
    got["t"] = tp["t"].grad
    for k in want:
        ref = want[k].numpy()
        err = float(np.max(np.abs(got[k].numpy() - ref)))
        assert err <= 1e-4 * max(float(np.max(np.abs(ref))), 1e-6), k


def test_generator_draws_the_jitter_and_remat_raises_under_grad():
    """A generator draws the jitter reproducibly; remat and remat_chunks,
    which once raised under grad, now give the gradients of no remat (the
    name is kept so that the test's history stays one)."""
    kw = dict(variant="satnerf", layers=2, feat=64, skips=(1,))
    tf = FieldConfig(**kw)
    tp = init_params(torch.Generator().manual_seed(0), tf, t_vocab=5, device="cpu")
    rays, extras = (torch.from_numpy(a) for a in synthetic_rays(4, 0, vocab=5))
    rcfg = trender.RenderConfig(field=tf, n_samples=8)
    a = trender.render_rays(tp, rcfg, rays, extras,
                            generator=torch.Generator().manual_seed(5))
    b = trender.render_rays(tp, rcfg, rays, extras,
                            generator=torch.Generator().manual_seed(5))
    c = trender.render_rays(tp, rcfg, rays, extras)
    assert torch.equal(a["depth"], b["depth"]) and not torch.equal(a["depth"], c["depth"])
    # remat and remat_chunks run under grad (the field recomputed in the
    # backward, tests/test_torch_hier.py) and give the gradients of no remat
    def grads(cfg):
        tp["field"].zero_grad()
        trender.render_rays(tp, cfg, rays, extras)["depth"].sum().backward()
        return [p.grad.clone() for p in tp["field"].parameters() if p.grad is not None]

    want = grads(rcfg)
    for knob in (dict(remat=True), dict(remat_chunks=2)):
        got = grads(dataclasses.replace(rcfg, **knob))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-6)
        with torch.no_grad():
            trender.render_rays(tp, dataclasses.replace(rcfg, **knob), rays, extras)
