"""The port's hierarchical samplers (``satnerf_torch.core.sampling``:
``sample_pdf``, ``sample_pdf_midpoint``) against the JAX package's, on the
same bins, weights and uniform draws.

Bars: 1e-5 abs on depths in [0, 2]. The cdf is a cumulative sum taken in
another order (a few f32 ulps apart), and the inverse CDF divides that
difference by the probability of the bin it lands in, so a sample in a
light bin moves by up to ~3e-6 here; the deterministic ladders are bit
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.core import sampling as jsamp
from satnerf_torch.core import sampling as tsamp
from torch_parity import max_err

TOL = 1e-5


def _bins_weights(n=23, s=15, seed=0):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.0, 2.0, (n, s + 1)), axis=1).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (n, s)).astype(np.float32)
    weights[:, :3] *= rng.uniform(size=(n, 1)) < 0.5  # empty leading bins
    return bins, weights


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n_importance", [1, 8, 128])
def test_sample_pdf_deterministic_matches_jax(n_importance):
    bins, w = _bins_weights()
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n_importance, det=True)
    got = tsamp.sample_pdf(*_t(bins, w), n_importance)
    assert got.shape == (bins.shape[0], n_importance)
    assert max_err(got, np.asarray(ref)) <= TOL


def test_sample_pdf_with_given_u_matches_jax_key():
    bins, w = _bins_weights(seed=1)
    key = jax.random.PRNGKey(4)
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 32, key=key)
    u = np.array(jax.random.uniform(key, (bins.shape[0], 32)))
    got = tsamp.sample_pdf(*_t(bins, w), 32, u=torch.from_numpy(u))
    assert max_err(got, np.asarray(ref)) <= TOL


def test_sample_pdf_all_zero_weights_matches_jax():
    bins, w = _bins_weights(seed=2)
    w[:5] = 0.0  # rays that saw nothing: uniform pdf after the eps
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 16, det=True)
    got = tsamp.sample_pdf(*_t(bins, w), 16)
    assert bool(torch.isfinite(got).all())
    assert max_err(got, np.asarray(ref)) <= TOL


def test_sample_pdf_u_on_a_cdf_step_takes_the_right_side():
    """A u equal to a cdf value lands in the bin above it (searchsorted
    right), and a zero-width cdf step hits the denominator guard."""
    bins = np.array([[0.0, 1.0, 2.0, 3.0, 4.0]], np.float32)
    w = np.array([[1.0, 0.0, 1.0, 2.0]], np.float32)
    pdf = (w + 1e-5) / np.sum(w + 1e-5)
    cdf = np.concatenate([[0.0], np.cumsum(pdf)]).astype(np.float32)
    u = np.array([[0.0, cdf[1], cdf[2], cdf[3], 0.5, 1.0]], np.float32)
    ref = jsamp._inverse_cdf_interp(jnp.asarray(bins), jnp.asarray(cdf[None]),
                                    jnp.asarray(u), 4, clamp_denom_below=1e-5)
    got = tsamp._inverse_cdf_interp(*_t(bins, cdf[None], u), 4, clamp_denom_below=1e-5)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    key = jax.random.PRNGKey(0)
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 6, key=key)
    u = np.array(jax.random.uniform(key, (1, 6)))
    assert max_err(tsamp.sample_pdf(*_t(bins, w), 6, u=torch.from_numpy(u)),
                   np.asarray(ref)) <= TOL


@pytest.mark.parametrize("n_importance", [4, 64])
def test_sample_pdf_midpoint_matches_jax(n_importance):
    bins, w = _bins_weights(seed=3)
    w[0] = 0.0  # the eps-guarded normaliser
    ref = jsamp.sample_pdf_midpoint(jnp.asarray(bins), jnp.asarray(w), n_importance)
    got = tsamp.sample_pdf_midpoint(*_t(bins, w), n_importance)
    assert got.shape == (bins.shape[0], n_importance)
    assert max_err(got, np.asarray(ref)) <= TOL


@pytest.mark.parametrize("n", [2, 64, 128, 129, 193])
def test_unit_ladder_is_jnp_linspace_bit_for_bit(n):
    ref = np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32))
    assert np.array_equal(tsamp._unit_ladder(n, torch.zeros(1)).numpy(), ref)
