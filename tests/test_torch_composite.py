"""satnerf_torch compositing (core.compositing, ops.composite) against the
JAX package: ``convert_sigmas``/``composite_scalar`` and the Pallas kernel
``composite_pallas`` in interpret mode. Bars of tests/test_pallas.py:33-36:
1e-6 for weights and transparency, 1e-5 for depth and rgb."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.core import compositing as jc
from satnerf_tpu.ops.pallas.composite import composite_pallas
from satnerf_torch.core import compositing as tc
from satnerf_torch.ops import composite as tcomp
from torch_parity import max_err

torch.set_num_threads(2)

BARS = {"weights": 1e-6, "transparency": 1e-6, "depth": 1e-5, "rgb": 1e-5}
NAMES = ("weights", "transparency", "depth", "rgb")


def _data(b=100, s=64, seed=0):
    rng = np.random.default_rng(seed)
    sigmas = rng.uniform(-1, 5, (b, s)).astype(np.float32)  # some negative
    z = np.sort(rng.uniform(0.1, 1.0, (b, s)).astype(np.float32), axis=1)
    albedo = rng.uniform(0, 1, (b, s, 3)).astype(np.float32)
    sun = rng.uniform(0, 1, (b, s)).astype(np.float32)
    sky = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    return sigmas, z, albedo, sun, sky


def _port(*arrays):
    return tcomp.composite_reference(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("b,s", [(100, 64), (77, 64), (33, 37)])
def test_reference_matches_jax_pallas_kernel(b, s):
    data = _data(b, s)
    ref = composite_pallas(*map(jnp.asarray, data), block_b=32, interpret=True)
    got = _port(*data)
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape, name
        assert max_err(g, np.asarray(r)) <= BARS[name], name


@pytest.mark.parametrize("b", [100, 77])
def test_reference_matches_jax_convert_sigmas_chain(b):
    sigmas, z, albedo, sun, sky = _data(b, seed=1)
    w, depth, t, _ = jc.convert_sigmas(jnp.asarray(sigmas), jnp.asarray(z))
    irr = sun[..., None] + (1 - sun[..., None]) * sky[:, None, :]
    rgb = jnp.clip(jnp.sum(w[..., None] * albedo * irr, axis=-2), 0.0, 1.0)
    got = _port(sigmas, z, albedo, sun, sky)
    for name, r, g in zip(NAMES, (w, t, depth, rgb), got):
        assert max_err(g, np.asarray(r)) <= BARS[name], name


def test_convert_sigmas_matches_jax():
    sigmas, z, *_ = _data(64, 48, seed=2)
    ref = jc.convert_sigmas(jnp.asarray(sigmas), jnp.asarray(z))
    got = tc.convert_sigmas(torch.from_numpy(sigmas), torch.from_numpy(z))
    for name, r, g in zip(("weights", "depth", "transparency", "alphas"), ref, got):
        assert max_err(g, np.asarray(r)) <= 1e-6, name


def test_composite_scalar_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 1, (20, 16)).astype(np.float32)
    v = rng.normal(size=(20, 16, 5)).astype(np.float32)
    ref = jc.composite_scalar(jnp.asarray(w), jnp.asarray(v))
    got = tc.composite_scalar(torch.from_numpy(w), torch.from_numpy(v))
    assert max_err(got, np.asarray(ref)) <= 1e-6


def test_last_delta_is_finite_for_any_density():
    """delta_last = 1e10: exp(-1e10 * sigma) must underflow to 0, not NaN."""
    sigmas, z, albedo, sun, sky = _data(4, 8, seed=4)
    sigmas[:, -1] = [0.0, 1e-30, 1e3, -5.0]
    out = _port(sigmas, z, albedo, sun, sky)
    for t in out:
        assert torch.isfinite(t).all()
    w = out[0]
    assert w[0, -1] == 0 and w[3, -1] == 0  # relu(sigma) == 0: no opacity


def test_wrapper_takes_the_plain_path_for_cpu_tensors():
    data = [torch.from_numpy(a) for a in _data(10, 16, seed=5)]
    before = tcomp.LAUNCHES
    got = tcomp.composite(*data)
    ref = tcomp.composite_reference(*data)
    assert tcomp.LAUNCHES == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
