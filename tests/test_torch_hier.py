"""The port's hierarchical pass (``n_importance``, ``use_fine_network``), its
rematerialisation under autograd (``remat``, ``remat_chunks``) and the
serving of a fine field, against the JAX package.

- ``render_rays`` with the fine pass, deterministic: every key of the fine
  result and of the nested coarse one. Coarse keys within 5e-5 abs (the
  field bar, tests/test_pallas_trunk.py:61). The fine depths are drawn by
  inverse CDF from the coarse weights, which divides their 1e-7-level
  differences by the bin's probability, so the fine keys are held to 1e-4
  of each key's largest value.
- ``remat`` and ``remat_chunks=2`` gradients against the same render without
  them (1e-5 of each tensor's largest gradient: the same arithmetic, the
  chunked products summed in another order) and against ``jax.grad`` of
  JAX's remat render (1e-4).
- One hierarchical training step: every loss term (the ``c_`` ones too) and
  the updated coarse and fine params, with the bars of
  tests/test_torch_step.py.
- ``render_image_chunked``'s ``<k>_coarse`` keys, and ``RenderService``
  with a fine field from params and from a ``save_lightning_ckpt``
  checkpoint.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models.field import FieldConfig as JFieldConfig
from satnerf_tpu.models.import_torch import save_lightning_ckpt
from satnerf_tpu.render import renderer as jr
from satnerf_tpu.train import step as jstep
from satnerf_tpu.train.state import TrainState as JTrainState
from satnerf_tpu.train.state import init_params as jinit_params
from satnerf_tpu.train.state import make_optimizer
from satnerf_torch.models.field import FieldConfig
from satnerf_torch.models.import_params import field_state_from_params, params_from_jax
from satnerf_torch.render import renderer as tr
from satnerf_torch.serve import service as tservice
from satnerf_torch.train import step as tstep
from satnerf_torch.train.state import create_train_state, init_params, trainable
from test_torch_step import LR, _batch, _check
from torch_parity import max_err, synthetic_rays

FIELD = {"xla": dict(variant="rs_semantic", layers=3, feat=64, skips=(1,), mapping=True),
         "pallas": dict(variant="rs_semantic", layers=3, feat=256, skips=(1,), mapping=True,
                        trunk_impl="pallas")}
HIER = dict(n_samples=8, n_importance=8, use_fine_network=True, sc_stride=2)
N_RAYS = 16


def _table():
    return np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params(impl: str):
    """JAX params with a fine field, and the port's copy of them."""
    jf = JFieldConfig(**FIELD[impl])
    params = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(2), jf, t_vocab=5,
                                                   use_fine_network=True))
    return jf, params


def _port_params(impl: str):
    _, params = _params(impl)
    return params_from_jax(params, FieldConfig(**FIELD[impl]), device="cpu")


def _rel(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not np.any(b):
        return float(np.max(np.abs(a)))
    return float(np.max(np.abs(a - b)) / float(np.max(np.abs(b))))


def _assert_passes_match(got: dict, ref: dict):
    assert set(got) == set(ref) and set(got["coarse"]) == set(ref["coarse"])
    for k, r in ref["coarse"].items():
        if k != "semantic_label":
            assert max_err(got["coarse"][k], np.asarray(r, np.float32)) < 5e-5, ("coarse", k)
    for k, r in ref.items():
        if k not in ("coarse", "semantic_label"):
            assert _rel(got[k], np.asarray(r, np.float32)) < 1e-4, k


@pytest.mark.parametrize("fine_net", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_hierarchical_render_matches_jax(impl, fine_net):
    jf, params = _params(impl)
    rays, extras = synthetic_rays(N_RAYS)
    over = dict(HIER, use_fine_network=fine_net)
    ref = jr.render_rays(dict(params, t=_table()), jr.RenderConfig(field=jf, **over),
                         jnp.asarray(rays), jnp.asarray(extras))
    tp = _port_params(impl)
    tp["t"] = torch.from_numpy(_table())
    with torch.no_grad():
        got = tr.render_rays(tp, tr.RenderConfig(field=FieldConfig(**FIELD[impl]), **over),
                             torch.from_numpy(rays), torch.from_numpy(extras))
    assert got["weights"].shape == (N_RAYS, 16) and got["weights_sc"].shape == (N_RAYS, 8)
    assert got["coarse"]["weights"].shape == (N_RAYS, 8)
    _assert_passes_match(got, jax.tree.map(np.asarray, ref))


def test_generator_draws_the_jitter_then_u():
    tp = _port_params("xla")
    rcfg = tr.RenderConfig(field=FieldConfig(**FIELD["xla"]), **HIER)
    rays, extras = (torch.from_numpy(a) for a in synthetic_rays(N_RAYS))
    with torch.no_grad():
        a = tr.render_rays(tp, rcfg, rays, extras, generator=torch.Generator().manual_seed(9))
        g = torch.Generator().manual_seed(9)
        noise = torch.rand((N_RAYS, 8), generator=g)
        u = torch.rand((N_RAYS, 8), generator=g)
        b = tr.render_rays(tp, rcfg, rays, extras, noise=noise, u=u)
    for k in ("depth", "weights", "rgb"):
        assert torch.equal(a[k], b[k]) and torch.equal(a["coarse"][k], b["coarse"][k]), k


# -- remat under autograd ------------------------------------------------------------


def _loss(r):
    return (r["rgb"].sum() + r["depth"].sum() + r["semantic_logits"].sum()
            + r["sun_sc"].sum() + r["beta"].sum() + r["coarse"]["depth"].sum())


def _port_grads(impl, **knobs):
    tp = _port_params(impl)
    tp["t"] = torch.from_numpy(_table()).requires_grad_(True)
    rays, extras = (torch.from_numpy(a) for a in synthetic_rays(N_RAYS, seed=1))
    rcfg = tr.RenderConfig(field=FieldConfig(**FIELD[impl]), **HIER, **knobs)
    _loss(tr.render_rays(tp, rcfg, rays, extras)).backward()
    # a head the loss does not read gets no gradient: count it as zeros
    out = {f"{k}/{n}": torch.zeros_like(p) if p.grad is None else p.grad
           for k in ("field", "fine") for n, p in tp[k].named_parameters()}
    out["t"] = tp["t"].grad
    return out


@pytest.mark.parametrize("knob", [dict(remat=True), dict(remat_chunks=2),
                                  dict(remat_chunks=3)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_grads_match_no_remat(impl, knob):
    want, got = _port_grads(impl), _port_grads(impl, **knob)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k].numpy()) <= 1e-5, k


def test_remat_chunks_grads_match_jax():
    jf, params = _params("xla")
    rays, extras = synthetic_rays(N_RAYS, seed=1)
    rcfg = jr.RenderConfig(field=jf, **HIER, remat_chunks=2)

    def jloss(p):
        r = jr.render_rays(p, rcfg, jnp.asarray(rays), jnp.asarray(extras))
        return (jnp.sum(r["rgb"]) + jnp.sum(r["depth"]) + jnp.sum(r["semantic_logits"])
                + jnp.sum(r["sun_sc"]) + jnp.sum(r["beta"]) + jnp.sum(r["coarse"]["depth"]))

    gj = jax.tree.map(np.asarray, jax.grad(jloss)(dict(params, t=_table())))
    got = _port_grads("xla", remat_chunks=2)
    want = {f"{k}/{n}": v for k in ("field", "fine")
            for n, v in field_state_from_params(gj[k]).items()}
    want["t"] = torch.from_numpy(np.array(gj["t"]))
    for k in want:
        assert _rel(got[k], want[k].numpy()) <= 1e-4, k


# -- one hierarchical training step ------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas"])
def test_hierarchical_step_matches_jax(impl):
    jf, params = _params(impl)
    jparams = jax.tree.map(jnp.asarray, params)
    batch = _batch(depth=4)
    skw = dict(steps_per_epoch=4, sc_lambda=0.05, first_beta_epoch=0, depth=True,
               semantic=True, car_index=4, use_car_reg_loss=True, car_reg_loss_start=0)
    rkw = dict(HIER, remat_chunks=2)
    opt = make_optimizer(LR, "step", 4)
    state = JTrainState(params=jparams, opt_state=opt.init(jparams),
                        step=jnp.asarray(0, jnp.int32))
    with jax.disable_jit():
        new_state, jm = jstep.build_train_step(
            jstep.StepConfig(render=jr.RenderConfig(field=jf, **rkw), **skw), opt)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    tf = FieldConfig(**FIELD[impl])
    tstate = create_train_state(params_from_jax(params, tf, device="cpu"), LR, "step", 4)
    scfg = tstep.StepConfig(render=tr.RenderConfig(field=tf, **rkw), **skw)
    tstate, tm = tstep.build_train_step(scfg)(
        tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert {"c_coarse_color", "c_coarse_ds", "c_coarse_semantic", "coarse_ds"} <= set(tm)
    assert "c_coarse_car_reg_loss" not in tm  # car-reg reads the fine result only
    want = params_from_jax(jax.tree.map(np.asarray, new_state.params), tf, device="cpu")
    _check(jm, tm, tstate, want)  # the loss terms and the coarse field
    fine_state = types.SimpleNamespace(params={"field": tstate.params["fine"],
                                               "t": tstate.params["t"]})
    _check(jm, tm, fine_state, {"field": want["fine"], "t": want["t"]})


def test_init_params_adds_a_trainable_fine_field():
    cfg = FieldConfig(**FIELD["xla"])
    p = init_params(torch.Generator().manual_seed(0), cfg, t_vocab=5, device="cpu",
                    use_fine_network=True)
    n_field = len(list(p["field"].parameters()))
    params = trainable(p)
    assert len(params) == 2 * n_field + 1
    assert all(a is b for a, b in zip(params[n_field:2 * n_field], p["fine"].parameters()))
    assert not torch.equal(p["field"].fc_net[0].weight, p["fine"].fc_net[0].weight)


# -- eval and serving ----------------------------------------------------------------


def test_render_image_chunked_surfaces_the_coarse_keys_like_jax():
    jf, params = _params("pallas")
    rays, extras = synthetic_rays(40, seed=9)
    ref = jr.render_image_chunked(dict(params, t=_table()),
                                  jr.RenderConfig(field=jf, **HIER, solar_correction=False),
                                  rays, extras, chunk=16)
    tp = _port_params("pallas")
    tp["t"] = torch.from_numpy(_table())
    got = tr.render_image_chunked(
        tp, tr.RenderConfig(field=FieldConfig(**FIELD["pallas"]), **HIER,
                            solar_correction=False), rays, extras, chunk=16, device="cpu")
    assert set(got) == set(ref)
    assert {"rgb_coarse", "depth_coarse", "semantic_logits_coarse",
            "semantic_label_coarse"} <= set(got) and "coarse" not in got
    for k in ref:
        assert isinstance(got[k], np.ndarray) and got[k].shape == ref[k].shape, k
        if not k.startswith("semantic_label"):
            bar = 5e-5 if k.endswith("_coarse") else 1e-4 * max(np.abs(ref[k]).max(), 1.0)
            assert max_err(got[k], ref[k].astype(np.float32)) < bar, k


SMALL_HIER_PIPELINE = """
pipeline = "rs_semantic"
fc_units = 256
fc_layers = 3
fc_skips = [1]
n_samples = 8
n_importance = 8
use_fine_network = true
remat_chunks = 2
sc_stride = 2
t_embedding_vocab = 5
sc_lambda = 0.05
trunk_impl = "pallas"
"""


def test_render_service_serves_the_fine_field(tmp_path):
    jf, params = _params("pallas")
    pipe_fp = str(tmp_path / "pipeline.toml")
    with open(pipe_fp, "w") as f:
        f.write(SMALL_HIER_PIPELINE)
    ckpt_fp = save_lightning_ckpt(dict(params, t=_table()), str(tmp_path / "last.ckpt"))
    h, w = 4, 5
    rays, extras = synthetic_rays(h * w, seed=4)
    rcfg = jr.RenderConfig(field=jf, **HIER, solar_correction=False, remat_chunks=2)
    ref = jr.render_image_chunked(dict(params, t=_table()), rcfg, rays, extras, chunk=8)

    from_ckpt = tservice.RenderService.from_checkpoint(ckpt_fp, pipe_fp, device="cpu",
                                                       chunk=8)
    assert set(from_ckpt.params) == {"field", "fine", "t"}
    tp = _port_params("pallas")
    from_params = tservice.RenderService(
        {"field": tp["field"], "fine": tp["fine"].state_dict(), "t": _table()},
        from_ckpt.rcfg, chunk=8, device="cpu")
    for svc in (from_ckpt, from_params):
        out = svc.render_rays(rays, extras, h, w)
        bar = 1e-4 * max(np.abs(ref["depth"]).max(), 1.0)
        assert max_err(out["depth"], ref["depth"].reshape(h, w)) < bar
        assert max_err(out["rgb"], np.clip(ref["rgb"], 0, 1).reshape(h, w, 3)) < 1e-4
    # the fine field is really the one rendering the fine pass
    alone = tservice.RenderService({"field": tp["field"], "t": _table()}, from_ckpt.rcfg,
                                   chunk=8, device="cpu").render_rays(rays, extras, h, w)
    assert max_err(alone["depth"], out["depth"]) > 1e-3
