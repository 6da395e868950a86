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


def test_sample_pdf_top_rung_at_a_light_last_bin_is_a_difference_by_design():
    """The deterministic ladder's last rung (u = 1): the two packages' cdfs
    end a last bit apart around 1.0 (their normalising sums and cumulative
    sums add in other orders), and that bit decides whether u = 1 lies past
    the cdf's end (at or below 1: the sample at the last edge) or inside the
    last bin (the sample short of it by that bit over the bin's cdf step). Where the last
    bin holds less than the guard (eps, 1e-5) of the cdf, its step's
    denominator becomes 1 and the sample sits at the bin's first edge: it
    moves across the whole last bin. Every other sample agrees within TOL,
    and on one cdf the two inverse CDFs agree bit for bit (ROADMAP
    "Differences by design")."""
    rng = np.random.default_rng(0)
    n, s, eps = 4096, 6, 1e-5
    w = (rng.uniform(0.0, 1.0, (n, s)) ** 3).astype(np.float32)
    bins = np.sort(rng.uniform(0.0, 2.0, (n, s + 1)), axis=1).astype(np.float32)
    ref = np.asarray(jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 8, det=True))
    got = tsamp.sample_pdf(*_t(bins, w), 8).numpy()
    diff = np.abs(got - ref)
    assert set(np.nonzero(diff > TOL)[1].tolist()) == {7}  # the u = 1 rung alone
    wj = jnp.asarray(w) + eps
    cdf_j = np.asarray(jnp.cumsum(wj / jnp.sum(wj, axis=-1, keepdims=True), axis=-1))
    wt = torch.from_numpy(w) + eps
    cdf_t = torch.cumsum(wt / torch.sum(wt, dim=-1, keepdim=True), dim=-1).numpy()
    rows = np.nonzero(diff[:, 7] > TOL)[0]
    assert np.all(cdf_j[rows, -1] != cdf_t[rows, -1])  # the ends a last bit apart
    share = (w[:, -1] + eps) / (w + eps).sum(1)
    whole = rows[share[rows] < 0.5 * eps]  # steps under the guard: the whole bin
    assert len(whole) > 0
    # one end at or below 1.0 (u = 1 past it), the other above (u = 1 inside)
    assert np.all((cdf_j[whole, -1] <= 1.0) != (cdf_t[whole, -1] <= 1.0))
    assert np.allclose(diff[whole, 7], bins[whole, -1] - bins[whole, -2], rtol=0, atol=1e-5)
    # JAX's cdf through both inverse CDFs: the same samples, bit for bit
    cdf = np.concatenate([np.zeros((n, 1), np.float32), cdf_j], axis=1)
    u = np.broadcast_to(np.asarray(jnp.linspace(0.0, 1.0, 8, dtype=jnp.float32)), (n, 8)).copy()
    via_j = jsamp._inverse_cdf_interp(jnp.asarray(bins), jnp.asarray(cdf), jnp.asarray(u), s,
                                      clamp_denom_below=eps)
    via_t = tsamp._inverse_cdf_interp(*_t(bins, cdf, u), s, clamp_denom_below=eps)
    assert np.array_equal(via_t.numpy(), np.asarray(via_j))
    assert np.array_equal(np.asarray(via_j)[rows, 7], ref[rows, 7])
