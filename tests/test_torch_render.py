"""satnerf_torch.render.renderer (and the core math it runs) against the JAX
renderer, with the same weights, rays and sampling noise.

Every output key of ``render_rays`` is compared, with solar correction off
and on (sc_stride 1 and 2), with given z values, and with stratified noise
drawn by JAX and handed to the port. Bar: 5e-5 abs in f32 (the field bar,
tests/test_pallas_trunk.py:61), 0.1 in bf16; semantic labels must agree
wherever the top two composited logits differ by more than 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.core import encoding as jenc
from satnerf_tpu.core import rays as jrays
from satnerf_tpu.core import sampling as jsamp
from satnerf_tpu.render import renderer as jr
from satnerf_torch.core import encoding as tenc
from satnerf_torch.core import rays as trays
from satnerf_torch.core import sampling as tsamp
from satnerf_torch.models.embeddings import embedding_lookup
from satnerf_torch.render import renderer as tr
from torch_parity import field_pair, max_err, synthetic_rays

FIELD = dict(variant="rs_semantic", layers=4, feat=256, skips=(2,), mapping=True)
N_RAYS, N_SAMPLES = 37, 16

# name -> (RenderConfig overrides, given z, noise, dtype)
CASES = {
    "sc_off": (dict(solar_correction=False), False, False, None),
    "sc_on": (dict(solar_correction=True), False, False, None),
    "sc_stride2": (dict(solar_correction=True, sc_stride=2), False, False, None),
    "given_z": (dict(solar_correction=False), True, False, None),
    "noise": (dict(solar_correction=True), False, True, None),
    "bf16": (dict(solar_correction=False, compute_dtype="bfloat16"), False, False, "bf16"),
}


def _table():
    return np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32)


def _z_vals():
    rng = np.random.default_rng(5)
    return np.sort(rng.uniform(0, 2, (N_RAYS, N_SAMPLES)).astype(np.float32), axis=1)


@functools.lru_cache(maxsize=None)
def _jax_render(case: str):
    over, given_z, noise, _ = CASES[case]
    jcfg, params, _, _ = field_pair(**FIELD)
    rcfg = jr.RenderConfig(field=jcfg, n_samples=N_SAMPLES, **over)
    rays, extras = synthetic_rays(N_RAYS)
    key = jax.random.PRNGKey(7) if noise else None
    out = jr.render_rays(
        {"field": params, "t": _table()}, rcfg, jnp.asarray(rays), jnp.asarray(extras),
        key=key, given_z_vals=jnp.asarray(_z_vals()) if given_z else None,
    )
    u = None
    if noise:  # the draws render_rays made: key -> (key_c, key_f), uniform(key_c)
        key_c, _ = jax.random.split(key)
        u = np.array(jax.random.uniform(key_c, (N_RAYS, N_SAMPLES)))
    return {k: np.asarray(v) for k, v in out.items()}, u


def _port_render(case: str, impl: str, u):
    over, given_z, _, _ = CASES[case]
    _, _, tcfg, module = field_pair(**dict(FIELD, trunk_impl=impl))
    rcfg = tr.RenderConfig(field=tcfg, n_samples=N_SAMPLES, **over)
    rays, extras = synthetic_rays(N_RAYS)
    with torch.no_grad():
        return tr.render_rays(
            {"field": module, "t": torch.from_numpy(_table())}, rcfg,
            torch.from_numpy(rays), torch.from_numpy(extras),
            noise=None if u is None else torch.from_numpy(u),
            given_z_vals=torch.from_numpy(_z_vals()) if given_z else None,
        )


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_render_rays_matches_jax(case, impl):
    ref, u = _jax_render(case)
    got = _port_render(case, impl, u)
    assert set(got) == set(ref)
    tol = 0.1 if CASES[case][3] == "bf16" else 5e-5
    for k, r in ref.items():
        if k == "semantic_label":
            continue
        assert tuple(got[k].shape) == r.shape, k
        assert max_err(got[k], r.astype(np.float32)) < tol, (k, max_err(got[k], r))
    logits = np.sort(ref["semantic_logits"], axis=-1)
    clear = (logits[:, -1] - logits[:, -2]) > 1e-4
    assert np.array_equal(got["semantic_label"].numpy()[clear],
                          ref["semantic_label"][clear])


def test_render_image_chunked_pads_the_last_chunk_like_jax():
    jcfg, params, tcfg, module = field_pair(**dict(FIELD, trunk_impl="pallas"))
    rays, extras = synthetic_rays(50, seed=9)
    table = _table()
    ref = jr.render_image_chunked(
        {"field": params, "t": table},
        jr.RenderConfig(field=jcfg, n_samples=N_SAMPLES, solar_correction=False),
        rays, extras, chunk=16,
    )
    got = tr.render_image_chunked(
        {"field": module, "t": torch.from_numpy(table)},
        tr.RenderConfig(field=tcfg, n_samples=N_SAMPLES, solar_correction=False),
        rays, extras, chunk=16, device="cpu",
    )
    assert set(got) == set(ref)
    for k in ref:
        assert isinstance(got[k], np.ndarray) and got[k].shape == ref[k].shape, k
        if k != "semantic_label":
            assert max_err(got[k], ref[k].astype(np.float32)) < 5e-5, k


def test_nerf_render_matches_jax():
    kw = dict(variant="nerf", layers=3, feat=128, skips=(1,), mapping=True, siren=False)
    jcfg, params, tcfg, module = field_pair(**kw)
    rays, extras = synthetic_rays(20, seed=2)
    ref = jr.render_rays({"field": params}, jr.RenderConfig(field=jcfg, n_samples=8),
                         jnp.asarray(rays), jnp.asarray(extras))
    with torch.no_grad():
        got = tr.render_rays({"field": module}, tr.RenderConfig(field=tcfg, n_samples=8),
                             torch.from_numpy(rays), torch.from_numpy(extras))
    assert set(got) == set(ref)
    for k in ref:
        assert max_err(got[k], np.asarray(ref[k])) < 5e-5, k


def test_unported_and_degenerate_options_raise():
    """No option is left unported: the hierarchical pass, which once raised,
    renders; a degenerate sc_stride still raises (the name is kept so that
    the test's history stays one)."""
    _, _, tcfg, module = field_pair(**FIELD)
    rays, extras = (torch.from_numpy(a) for a in synthetic_rays(4))
    params = {"field": module, "t": torch.from_numpy(_table())}
    # every option of the reference is ported: the hierarchical pass renders
    with torch.no_grad():
        out = tr.render_rays(params, tr.RenderConfig(field=tcfg, n_samples=8,
                                                     n_importance=8), rays, extras)
    assert out["weights"].shape == (4, 16) and out["coarse"]["weights"].shape == (4, 8)
    # a stride that leaves fewer than 2 solar-correction rungs raises, with or
    # without the hierarchical pass
    for over in (dict(n_samples=8, sc_stride=5), dict(n_samples=4, n_importance=60,
                                                      sc_stride=3)):
        with pytest.raises(ValueError, match="sc_stride"):
            tr.render_rays(params, tr.RenderConfig(field=tcfg, **over), rays, extras)


# -- core math ---------------------------------------------------------------


def test_sample_rays_deterministic_ladder_is_bit_exact():
    rays, _ = synthetic_rays(11)
    xyz_j, z_j = jsamp.sample_rays(jnp.asarray(rays), 64)
    xyz_t, z_t = tsamp.sample_rays(torch.from_numpy(rays), 64)
    assert np.array_equal(z_t.numpy(), np.asarray(z_j))
    assert max_err(xyz_t, np.asarray(xyz_j)) <= 1e-7


def test_sample_rays_noise_matches_jax_key():
    rays, _ = synthetic_rays(11)
    key = jax.random.PRNGKey(3)
    _, z_j = jsamp.sample_rays(jnp.asarray(rays), 16, key=key, perturb=0.7)
    u = np.array(jax.random.uniform(key, (11, 16)))
    _, z_t = tsamp.sample_rays(torch.from_numpy(rays), 16,
                               noise=torch.from_numpy(u), perturb=0.7)
    assert max_err(z_t, np.asarray(z_j)) <= 1e-6


@pytest.mark.parametrize("n_freqs", [0, 4, 10])
def test_positional_encoding_matches_jax(n_freqs):
    x = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    ref = np.asarray(jenc.positional_encoding(jnp.asarray(x), n_freqs))
    got = tenc.positional_encoding(torch.from_numpy(x), n_freqs)
    assert got.shape == ref.shape
    assert max_err(got, ref) <= 2e-6
    assert tenc.encoded_size(n_freqs, 3) == jenc.encoded_size(n_freqs, 3)


def test_ray_accessors_and_sun_dir_match_jax():
    rays, extras = synthetic_rays(6)
    for name in ("origins", "dir", "near", "fars"):
        assert np.array_equal(trays.ray_component(rays, name),
                              jrays.ray_component(rays, name))
    for name in ("sun_d", "ts"):
        assert np.array_equal(trays.extras_component(extras, name),
                              jrays.extras_component(extras, name))
    assert np.array_equal(trays.construct_sun_dir(40.0, 130.0, 5),
                          jrays.construct_sun_dir(40.0, 130.0, 5))
    with pytest.raises(KeyError):
        trays.ray_component(rays, "colour")


def test_embedding_lookup_matches_take():
    table = _table()
    ids = np.array([0, 4, 2, 2], np.int32)
    got = embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    assert np.array_equal(got.numpy(), np.take(table, ids, axis=0))
