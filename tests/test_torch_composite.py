"""satnerf_torch compositing (core.compositing, ops.composite) against the
JAX package: ``convert_sigmas``/``composite_scalar`` and the Pallas kernel
``composite_pallas`` in interpret mode. Bars of tests/test_pallas.py:33-36:
1e-6 for weights and transparency, 1e-5 for depth and rgb."""

import jax
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


# -- backward ----------------------------------------------------------------


def _jax_rgb(sigmas, z, albedo, sun, sky_per_sample):
    w, depth, t, _ = jc.convert_sigmas(sigmas, z)
    irr = sun[..., None] + (1 - sun[..., None]) * sky_per_sample
    rgb = jnp.clip(jnp.sum(w[..., None] * albedo * irr, axis=-2), 0.0, 1.0)
    return w, t, depth, rgb


def _cotangents(b, s, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s), (b, s), (b,), (b, 3))]


def _jax_grads(data, cots):
    sigmas, z, albedo, sun, sky = map(jnp.asarray, data)
    s = sigmas.shape[1]

    def f(sg, alb, sn, sk_s):
        outs = _jax_rgb(sg, z, alb, sn, sk_s)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    # the reference evaluates sky per sample: (B, S, 3)
    sky_s = jnp.broadcast_to(sky[:, None, :], (sky.shape[0], s, 3))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3))(
        sigmas, albedo, sun, sky_s)]


def _port_grads(data, cots):
    ins = [torch.from_numpy(a).requires_grad_(i != 1) for i, a in enumerate(data)]
    outs = tcomp.composite(*ins)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [ins[i].grad.numpy() for i in (0, 2, 3, 4)]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("b,s", [(100, 64), (33, 37)])
def test_backward_matches_jax_grad(b, s):
    data = list(_data(b, s, seed=6))
    data[0][:4] = -np.abs(data[0][:4])  # rays whose sigma is all <= 0
    cots = _cotangents(b, s, 8)
    g_sig, g_alb, g_sun, g_sky_s = _jax_grads(data, cots)
    got = _port_grads(data, cots)
    assert _rel(got[0], g_sig) <= 1e-6
    assert _rel(got[1], g_alb) <= 1e-5
    assert _rel(got[2], g_sun) <= 1e-6
    # per-ray sky: its gradient is the sum of the reference's per-sample ones
    assert _rel(got[3], g_sky_s.sum(axis=1)) <= 1e-6
    # rays with no density pass no gradient to sigma
    assert np.all(got[0][:4] == 0.0)


def test_per_ray_sky_gives_the_sky_heads_parameter_gradient():
    """Every sample of a ray evaluates the sky head on the same sun direction,
    so the per-ray gradient reaches the head's parameters as the reference's
    per-sample gradients do."""
    b, s = 20, 16
    data = _data(b, s, seed=9)
    rng = np.random.default_rng(10)
    sun_d = rng.normal(size=(b, 3)).astype(np.float32)
    w1 = rng.normal(size=(3, 8)).astype(np.float32)
    w2 = rng.normal(size=(8, 3)).astype(np.float32) * 0.3
    cots = _cotangents(b, s, 11)

    def sky_head(w1_, w2_, d):
        return 1.0 / (1.0 + jnp.exp(-(jnp.maximum(d @ w1_, 0.0) @ w2_)))

    def f_ref(w1_, w2_):
        d_s = jnp.broadcast_to(jnp.asarray(sun_d)[:, None], (b, s, 3))
        outs = _jax_rgb(*map(jnp.asarray, data[:4]), sky_head(w1_, w2_, d_s))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    ref = [np.asarray(g) for g in jax.grad(f_ref, argnums=(0, 1))(w1, w2)]
    tw1, tw2 = (torch.from_numpy(w).requires_grad_(True) for w in (w1, w2))
    sky = torch.sigmoid(torch.relu(torch.from_numpy(sun_d) @ tw1) @ tw2)
    outs = tcomp.composite(*(torch.from_numpy(a) for a in data[:4]), sky)
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, cots)).backward()
    assert _rel(tw1.grad.numpy(), ref[0]) <= 1e-5
    assert _rel(tw2.grad.numpy(), ref[1]) <= 1e-5
