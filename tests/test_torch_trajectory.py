"""The port's training trajectory against the JAX package's, on the CPU.

Both packages start from the same parameters (JAX ``init_params`` carried
over by ``params_from_jax``) and take the same training steps on the same
batches, on the deterministic ladder (JAX ``key=None``, no generator in the
port), under the "step" LR schedule. The run crosses every switch of a
training run: the depth drop, the beta gate (epoch 2) and the car-reg start
(epoch 3). Cases: rs_semantic, satnerf, rs_semantic with ``sc_stride`` 2,
rs_semantic with the hierarchical pass (``n_importance`` 8 inverse-CDF depths
on the deterministic ladder, a fine field apart, ``remat_chunks`` 2) and
rs_semantic at 12 encoding frequencies (c_in 72, the JAX package's
``--posenc-freq`` lever) on a seeded ray pool, batches drawn by one index stream; and rs_semantic on
a generated scene whose batches each package draws from its own loaded
dataset (RPC rays, normalisation, the tie-point depth set) through its own
ray store and ``EpochSampler``, with its own pipeline's step configs and
depth-drop step. That case first holds the two loaded datasets equal.

Lengths. rs_semantic on the pool takes 120 steps (12 epochs of 10), the
hierarchical, satnerf and ``sc_stride`` 2 cases 60 (the depth drop and
car-reg at step 30, the beta gate at 20), the 12-frequency case 40. The dataset case takes 60 steps (max_train_steps 60: the depth
drop at 15, the beta gate at 36, car-reg from 54): past about step 75 its
first trunk layer drifts from the JAX package's faster than a bar can
follow (1.6e-4 of the tensor's largest element at step 120), while both
packages' gradients at the same parameters still agree to 6e-6 of each
tensor's largest element at every step checked.

Bars. Loss terms: within 1e-5 of their value at every step (each term
relative to max(|JAX value|, 1e-3); a term that JAX gives as 0 must be 0 in
the port). Parameters after the last step: every element within 1e-4 of its
tensor's largest absolute element, the fine field's too. Both packages sum
in f32 in another
order; these runs agree to about 2e-6 of each loss term and 1.1e-5 of each
tensor's largest element, so the parameter bar stands about 10x above the
reading.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu import configs as jconfigs
from satnerf_tpu.datasets.synthetic import generate_scene as jgenerate
from satnerf_tpu.models.field import FieldConfig as JFieldConfig
from satnerf_tpu.pipelines import load_pipeline as jload_pipeline
from satnerf_tpu.render import renderer as jrender
from satnerf_tpu.train import data as jdata
from satnerf_tpu.train import step as jstep
from satnerf_tpu.train.state import TrainState as JTrainState
from satnerf_tpu.train.state import init_params as jinit_params
from satnerf_tpu.train.state import make_optimizer
from satnerf_torch import configs as tconfigs
from satnerf_torch.datasets.synthetic import generate_scene as tgenerate
from satnerf_torch.models.field import FieldConfig
from satnerf_torch.models.import_params import params_from_jax
from satnerf_torch.pipelines import load_pipeline as tload_pipeline
from satnerf_torch.render import renderer as trender
from satnerf_torch.train import data as tdata
from satnerf_torch.train import step as tstep
from satnerf_torch.train.state import create_train_state
from torch_parity import synthetic_rays

torch.set_num_threads(2)

SPE = 10  # steps per epoch on the ray pool: beta gate at step 20, car-reg at 30
DEPTH_DROP = 30  # on the pool
LR = 5e-4
N_SAMPLES = 16
RAYS, DEPTH_RAYS = 64, 32
POOL, DEPTH_POOL = 640, 96
TOL_LOSS = 1e-5
# the hierarchical case: the JAX package's production run's pass, cut to size
HIER = dict(n_importance=8, use_fine_network=True, remat_chunks=2)
TOL_PARAM = 1e-4
# the generated scene: 2 train + 1 test views of 24^2 (an epoch of 18 steps),
# 60 steps: the depth drop at 0.25 x 60 = 15
SCENE = dict(n_train=2, n_test=1, img_size=24, n_tie_points=60)
SCENE_STEPS, SCENE_DEPTH_DROP = 60, 15


def _pool(seed: int = 0) -> tuple:
    """A seeded ray pool and a tie-point pool with every key a step reads
    (a car label on some rays, for the car-reg term)."""
    rays, extras = synthetic_rays(POOL, seed, vocab=5)
    rng = np.random.default_rng(seed + 1)
    pool = {"rays": rays, "extras": extras,
            "rgbs": rng.uniform(0, 1, (POOL, 3)).astype(np.float32),
            "semantic": rng.integers(0, 5, (POOL, 1)).astype(np.int32),
            "semantic_sparsity_mask": rng.uniform(size=POOL) > 0.2}
    depth = {"rays": rays[:DEPTH_POOL], "extras": extras[:DEPTH_POOL],
             "depths": rng.uniform(0.5, 1.5, (DEPTH_POOL,)).astype(np.float32),
             "weights": rng.uniform(0.5, 1, (DEPTH_POOL,)).astype(np.float32)}
    return pool, depth


class _Pair:
    """The two packages' train states and step programs (with and without
    depth), stepped on the same batches."""

    def __init__(self, jcfg, tcfg, j_scfgs, t_scfgs, t_vocab, spe, epochs, fine=False):
        params = jinit_params(jax.random.PRNGKey(0), jcfg, t_vocab=t_vocab,
                              use_fine_network=fine)
        opt = make_optimizer(LR, "step", spe, epochs)
        self.jstate = JTrainState(params=params, opt_state=opt.init(params),
                                  step=jnp.asarray(0, jnp.int32))
        self.jsteps = {d: jax.jit(jstep.build_train_step(c, opt)) for d, c in j_scfgs.items()}
        tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
        self.tstate = create_train_state(tparams, LR, "step", spe, epochs)
        self.tsteps = {d: tstep.build_train_step(c) for d, c in t_scfgs.items()}
        self.jcfg, self.tcfg = jcfg, tcfg
        self.worst = {}

    def step(self, i: int, jbatch: dict, tbatch: dict, depth: bool) -> None:
        self.jstate, jm = self.jsteps[depth](
            self.jstate, {k: jnp.asarray(v) for k, v in jbatch.items()}, None)
        self.tstate, tm = self.tsteps[depth](
            self.tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in tbatch.items()})
        assert set(tm) == set(jm), (i, sorted(set(tm) ^ set(jm)))
        for k in jm:
            ref, got = float(jm[k]), float(tm[k])
            err = abs(got - ref) / max(abs(ref), 1e-3)
            self.worst[k] = max(self.worst.get(k, 0.0), err)
            assert err <= TOL_LOSS and (ref != 0.0 or got == 0.0), (
                f"step {i}: {k} port {got} jax {ref}")

    def check_params(self, steps: int) -> None:
        assert int(self.tstate.step) == int(self.jstate.step) == steps
        want = params_from_jax(jax.tree.map(np.asarray, self.jstate.params), self.tcfg,
                               device="cpu")
        got, ref = {}, {}
        for key in ("field", "fine"):
            if want.get(key) is not None:
                got.update({f"{key}.{k}": v
                            for k, v in self.tstate.params[key].state_dict().items()})
                ref.update({f"{key}.{k}": v for k, v in want[key].state_dict().items()})
        for k in ("t", "t_s"):
            if want.get(k) is not None:
                got[k], ref[k] = self.tstate.params[k].detach(), want[k].detach()
        assert set(got) == set(ref)
        for k in ref:
            err = float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
            assert err <= TOL_PARAM, (k, err)


def _pool_case(variant: str, sc_stride: int, steps: int, hier: bool,
               n_freq: int | None = None) -> _Pair:
    fkw = dict(variant=variant, layers=3, feat=64, skips=(1,),
               mapping=variant == "rs_semantic")
    if n_freq is not None:
        fkw["mapping_pos_n_freq"] = n_freq
    jcfg, tcfg = JFieldConfig(**fkw), FieldConfig(**fkw)
    rkw = dict(n_samples=N_SAMPLES, sc_stride=sc_stride, **(HIER if hier else {}))
    semantic = variant == "rs_semantic"
    skw = dict(steps_per_epoch=SPE, sc_lambda=0.05, first_beta_epoch=2, semantic=semantic,
               car_index=4 if semantic else -1, ignore_car_index=False,
               use_car_reg_loss=semantic, car_reg_loss_start=3)
    j_scfgs = {d: jstep.StepConfig(render=jrender.RenderConfig(field=jcfg, **rkw), depth=d,
                                   **skw) for d in (True, False)}
    t_scfgs = {d: tstep.StepConfig(render=trender.RenderConfig(field=tcfg, **rkw), depth=d,
                                   **skw) for d in (True, False)}
    return _Pair(jcfg, tcfg, j_scfgs, t_scfgs, 5, SPE, steps // SPE, fine=hier)


@pytest.mark.parametrize("variant,sc_stride,steps,hier,n_freq", [
    ("rs_semantic", 1, 120, False, None), ("satnerf", 1, 60, False, None),
    ("rs_semantic", 2, 60, False, None), ("rs_semantic", 1, 60, True, None),
    ("rs_semantic", 1, 40, False, 12)],
    ids=["rs_semantic", "satnerf", "rs_semantic-sc_stride2", "rs_semantic-hier",
         "rs_semantic-posenc12"])
def test_trajectory_matches_jax(variant, sc_stride, steps, hier, n_freq):
    """On one index stream over a seeded pool: the beta gate at step 20,
    the depth drop and car-reg at 30."""
    pair = _pool_case(variant, sc_stride, steps, hier, n_freq)
    if n_freq is not None:
        assert pair.tcfg.xyz_in == pair.jcfg.xyz_in == 6 * n_freq
    pool, depth = _pool()
    sampler = tdata.EpochSampler(POOL, RAYS, seed=0)
    dsampler = tdata.EpochSampler(DEPTH_POOL, DEPTH_RAYS, seed=1)
    for i in range(steps):
        idx = sampler.next_batch()
        batch = {k: v[idx] for k, v in pool.items()}
        use_depth = i < DEPTH_DROP
        if use_depth:
            didx = dsampler.next_batch()
            batch.update({f"depth_{k}": v[didx] for k, v in depth.items()})
        pair.step(i, batch, batch, use_depth)
    gates = {"beta_loss_activated", "car_reg_loss_activated"} & set(pair.worst)
    assert len(gates) == (2 if variant == "rs_semantic" else 1)
    pair.check_params(steps)


def _main_cfgs(base, datasets_dp, cache):
    run = dict(dataset_name="SYN", datasets_dp=str(datasets_dp), cache_dp=str(base / cache),
               workspace_dp=str(base / "training"), seed=0, max_train_steps=SCENE_STEPS)
    pipe = dict(n_samples=N_SAMPLES, fc_layers=3, fc_units=64, fc_skips=[1],
                batch_size=RAYS, learnrate=LR, sparsity_n_images=1,
                ignore_car_index=False, use_car_reg_loss=True, car_reg_loss_start=3,
                lambda_c=1.0)
    return (jconfigs.MainConfig(jconfigs.RunConfig(**run), jconfigs.RSSemanticConfig(**pipe)),
            tconfigs.MainConfig(tconfigs.RunConfig(**run), tconfigs.RSSemanticConfig(**pipe)))


def test_trajectory_on_each_packages_own_dataset_matches_jax(tmp_path):
    """Each package generates the scene, loads it through its pipeline
    (RPC rays, normalisation, depth set), builds its ray stores and draws
    from its own samplers with one seed; its own pipeline gives the step
    configs and the depth-drop step."""
    jgenerate(str(tmp_path / "jax" / "SYN"), **SCENE)
    tgenerate(str(tmp_path / "port" / "SYN"), **SCENE)
    jmain, tmain = _main_cfgs(tmp_path, tmp_path / "jax", "cache_jax")
    tmain = _main_cfgs(tmp_path, tmp_path / "port", "cache_port")[1]
    jp, tp = jload_pipeline(jmain), tload_pipeline(tmain)
    jp.load_datasets()
    tp.load_datasets()
    for split, keys in (("rgb", tdata.TRAIN_KEYS), ("depth", tdata.DEPTH_KEYS)):
        jc, tc = jp.datasets[split].combined, tp.datasets[split].combined
        for k in keys:
            if k in jc or k in tc:
                np.testing.assert_array_equal(np.asarray(tc[k]), np.asarray(jc[k]),
                                              err_msg=f"{split}/{k}")

    n, n_depth = len(jp.datasets["rgb"]), int(jp.datasets["depth"].combined["rays"].shape[0])
    depth_batch = min(RAYS, n_depth)
    samplers = {}
    for name, data in (("jax", jdata), ("port", tdata)):
        samplers[name] = (data.EpochSampler(n, RAYS, seed=0),
                          data.EpochSampler(n_depth, depth_batch, seed=1))
    spe = samplers["port"][0].steps_per_epoch
    assert spe == samplers["jax"][0].steps_per_epoch and 3 * spe < SCENE_STEPS
    assert tp.ds_drop_step == jp.ds_drop_step == SCENE_DEPTH_DROP

    jstore = jdata.device_store(jp.datasets["rgb"].combined, jdata.TRAIN_KEYS)
    jdstore = jdata.device_store(jp.datasets["depth"].combined, jdata.DEPTH_KEYS)
    tstore = tdata.device_store(tp.datasets["rgb"].combined, tdata.TRAIN_KEYS, device="cpu")
    tdstore = tdata.device_store(tp.datasets["depth"].combined, tdata.DEPTH_KEYS,
                                 device="cpu")
    j_scfgs = {d: jp.step_config(spe, with_depth=d) for d in (True, False)}
    t_scfgs = {d: tp.step_config(spe, with_depth=d, device="cpu") for d in (True, False)}
    assert dataclasses.asdict(t_scfgs[True].render.field) == dataclasses.asdict(
        j_scfgs[True].render.field) | {"trunk_impl": "xla"}
    pair = _Pair(j_scfgs[False].render.field, t_scfgs[False].render.field, j_scfgs, t_scfgs,
                 tp.t_vocab, spe, max(SCENE_STEPS // spe, 1))
    for i in range(SCENE_STEPS):
        jb = jdata.gather_batch(jstore, jnp.asarray(samplers["jax"][0].next_batch()))
        tb = tdata.gather_batch(tstore, torch.from_numpy(samplers["port"][0].next_batch()))
        jd, td = i < jp.ds_drop_step, i < tp.ds_drop_step
        assert jd == td, f"step {i}: depth on in JAX {jd}, in the port {td}"
        if jd:
            jb.update(jdata.gather_batch(
                jdstore, jnp.asarray(samplers["jax"][1].next_batch()), prefix="depth_"))
            tb.update(tdata.gather_batch(
                tdstore, torch.from_numpy(samplers["port"][1].next_batch()),
                prefix="depth_"))
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        pair.step(i, jb, tb, jd)
    assert {"beta_loss_activated", "car_reg_loss_activated"} <= set(pair.worst)
    pair.check_params(SCENE_STEPS)
