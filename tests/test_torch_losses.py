"""satnerf_torch.train.losses against satnerf_tpu.train.losses: every loss
function on the same seeded render results, values within 1e-6 (relative
to the value, for the large terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.train import losses as jl
from satnerf_torch.train import losses as tl

torch.set_num_threads(2)


def _results(b=64, s=16, s_sc=16, seed=0, beta_s=False):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 0.2, (b, s)).astype(np.float32)
    r = {
        "rgb": rng.uniform(0, 1, (b, 3)).astype(np.float32),
        "weights": w,
        "beta": rng.uniform(0.01, 1, (b, s, 1)).astype(np.float32),
        "depth": rng.uniform(0, 2, (b,)).astype(np.float32),
        "semantic_logits": rng.normal(size=(b, 5)).astype(np.float32),
        "sun_sc": rng.uniform(0, 1, (b, s_sc, 1)).astype(np.float32),
        "transparency_sc": rng.uniform(0, 1, (b, s_sc)).astype(np.float32),
        "weights_sc": rng.uniform(0, 0.2, (b, s_sc)).astype(np.float32),
    }
    if beta_s:
        r["beta_semantic"] = rng.uniform(0.01, 1, (b, s, 1)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (b, 1)).astype(np.int32)
    mask = rng.uniform(size=b) > 0.3
    return r, gt, labels, mask


def _both(r):
    return ({k: jnp.asarray(v) for k, v in r.items()},
            {k: torch.from_numpy(v) for k, v in r.items()})


def _close(got, ref):
    got_l, got_d = got
    ref_l, ref_d = ref
    assert set(got_d) == set(ref_d)
    for k in ref_d:
        want = float(ref_d[k])
        assert abs(float(got_d[k]) - want) <= 1e-6 * max(1.0, abs(want)), k
    assert abs(float(got_l) - float(ref_l)) <= 1e-6 * max(1.0, abs(float(ref_l)))


def test_mse_psnr_and_nerf_loss():
    r, gt, *_ = _results()
    jr, tr = _both(r)
    _close(tl.nerf_loss(tr, torch.from_numpy(gt)), jl.nerf_loss(jr, jnp.asarray(gt)))
    assert abs(float(tl.psnr(tr["rgb"], torch.from_numpy(gt)))
               - float(jl.psnr(jr["rgb"], jnp.asarray(gt)))) < 1e-5


@pytest.mark.parametrize("s_sc", [16, 8])  # 8: a strided sc ladder (term2 rescale)
@pytest.mark.parametrize("fn", ["snerf_loss", "satnerf_loss"])
def test_rgb_losses_with_solar_correction(fn, s_sc):
    r, gt, *_ = _results(s_sc=s_sc)
    jr, tr = _both(r)
    for lam, on in ((0.05, True), (0.05, False), (0.0, True)):
        _close(getattr(tl, fn)(tr, torch.from_numpy(gt), lam, on),
               getattr(jl, fn)(jr, jnp.asarray(gt), lam, on))


def test_solar_correction_terms_detach_the_sc_transmittance():
    r, *_ = _results()
    tr = {k: torch.from_numpy(v).requires_grad_(True) for k, v in r.items()}
    d = tl.solar_correction_terms(tr, 0.05)
    (d["coarse_sc_term2"] + d["coarse_sc_term3"]).backward()
    assert tr["transparency_sc"].grad is None and tr["weights_sc"].grad is None
    assert tr["sun_sc"].grad is not None


@pytest.mark.parametrize("ds_w", ["ones", "weights"])
def test_depth_loss(ds_w):
    r, *_ = _results()
    rng = np.random.default_rng(5)
    tgt = rng.uniform(0, 2, (64,)).astype(np.float32)
    w = rng.uniform(0, 1, (64,)).astype(np.float32) if ds_w == "weights" else None
    jr, tr = _both(r)
    _close(tl.depth_loss(tr, torch.from_numpy(tgt),
                         1.0 if w is None else torch.from_numpy(w), 1000.0),
           jl.depth_loss(jr, jnp.asarray(tgt), 1.0 if w is None else jnp.asarray(w),
                         1000.0))


@pytest.mark.parametrize("car_index,ignore_car", [(-1, True), (4, True), (4, False)])
@pytest.mark.parametrize("with_mask", [True, False])
def test_semantic_loss(car_index, ignore_car, with_mask):
    r, _, labels, mask = _results()
    jr, tr = _both(r)
    _close(tl.semantic_loss(tr, torch.from_numpy(labels),
                            torch.from_numpy(mask) if with_mask else None, 0.04,
                            car_index, ignore_car),
           jl.semantic_loss(jr, jnp.asarray(labels),
                            jnp.asarray(mask) if with_mask else None, 0.04,
                            car_index, ignore_car))


def test_masked_ce_ignores_every_ray_safely():
    r, _, labels, _ = _results()
    jr, tr = _both(r)
    none = np.zeros(64, bool)
    _close(tl.semantic_loss(tr, torch.from_numpy(labels), torch.from_numpy(none)),
           jl.semantic_loss(jr, jnp.asarray(labels), jnp.asarray(none)))


@pytest.mark.parametrize("beta_s", [False, True])
@pytest.mark.parametrize("detach", [False, True])
def test_semantic_uncertainty_loss(beta_s, detach):
    r, _, labels, mask = _results(beta_s=beta_s)
    jr, tr = _both(r)
    _close(tl.semantic_uncertainty_loss(tr, torch.from_numpy(labels),
                                        torch.from_numpy(mask), 0.04, 4, True, detach),
           jl.semantic_uncertainty_loss(jr, jnp.asarray(labels), jnp.asarray(mask),
                                        0.04, 4, True, detach))


def test_semantic_uncertainty_detach_keeps_the_weights_gradient():
    r, _, labels, mask = _results()
    tr = {k: torch.from_numpy(v).requires_grad_(True) for k, v in r.items()}
    loss, _ = tl.semantic_uncertainty_loss(tr, torch.from_numpy(labels),
                                           torch.from_numpy(mask), detach_beta=True)
    loss.backward()
    assert tr["beta"].grad is None and tr["weights"].grad is not None


@pytest.mark.parametrize("cars", [True, False])  # False: no car ray (count-safe)
def test_semantic_car_reg_loss(cars):
    r, _, labels, mask = _results()
    if not cars:
        labels = np.where(labels == 4, 3, labels)
    jr, tr = _both(r)
    _close(tl.semantic_car_reg_loss(tr, torch.from_numpy(labels),
                                    torch.from_numpy(mask), 0.1, 4),
           jl.semantic_car_reg_loss(jr, jnp.asarray(labels), jnp.asarray(mask), 0.1, 4))
