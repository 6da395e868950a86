"""The arithmetic of the compositing kernels of satnerf_torch/csrc/composite.cu
(K5 and its backward), emulated in torch on the CPU, against the JAX package.

``emulate_composite`` and ``emulate_composite_backward`` follow the kernels'
order of operations: one warp per ray, lane l owning a run of
K = min(ceil(S/32), cap) consecutive samples per segment of 32 K samples (cap
8 in the forward, so one scan per ray up to 256 samples, and 2 in the
backward), the run's serial product and one exclusive warp product scan per
segment (a Hillis-Steele ``__shfl_up_sync`` scan), the forward's pre-clip
rgb as the backward's residual, the backward's affine maps (R -> c + q R)
composed serially in a lane and scanned once per segment across the warp
from the last lane, and dL/dsigma from the exp term that gave alpha. (nvcc may contract a product
and a sum into one FMA where the emulation rounds twice, so the emulation
gives the order, not the card's bits.) The forward is held against the JAX
kernel ``composite_pallas`` in interpret mode with the bars of
tests/test_pallas.py:33-36; the backward against ``jax.vjp`` of
``satnerf_tpu.core.compositing`` with the bars of
tests/test_torch_composite.py::test_backward_matches_jax_grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.core import compositing as jc
from satnerf_tpu.ops.pallas.composite import composite_pallas
from satnerf_torch.ops import composite as tcomp
from torch_parity import max_err

torch.set_num_threads(2)

MAX_RUN = 8  # csrc/composite.cu kMaxRunForward
MAX_RUN_BWD = 2  # csrc/composite.cu kMaxRunBackward
BARS = {"weights": 1e-6, "transparency": 1e-6, "depth": 1e-5, "rgb": 1e-5}
GRAD_BARS = {"sigmas": 1e-6, "albedo": 1e-5, "sun": 1e-6, "sky": 1e-6}
# training batches, a ragged ray, one sample; and rays longer than one
# 256-sample segment of the forward, so its carries run: (4, 300) and (4, 1024),
# MAX_SAMPLES
SHAPES = [(77, 64), (33, 192), (5, 37), (3, 1), (4, 300), (4, 1024)]


def _bars(bars: dict, s: int) -> dict:
    """The bars of 64 samples; past one 256-sample segment, scaled by S/64.

    T is an f32 product of S rounded factors, so its distance from the exact
    value grows with S, for the JAX kernel as for this one. Against the f64
    plain version on the dense data of ``_data`` (its near-transparent ray
    included) the emulation reached 1.4e-6 in T at (4, 300) and 6.1e-6 at
    (4, 1024); composite_pallas 1.0e-6 and 3.1e-6. Long rays are therefore
    held, both of them, against the f64 plain version at these bars."""
    return bars if s <= 32 * MAX_RUN else {k: v * s / 64 for k, v in bars.items()}


def run_length(s: int, cap: int = MAX_RUN) -> int:
    return min(-(-s // 32), cap)


def _lanes(x, s0, k):
    """Rows (B, S[, 3]) -> this segment's runs (B, 32, k[, 3]), zero past S."""
    b, s = x.shape[:2]
    seg = x[:, s0:s0 + 32 * k]
    pad = 32 * k - seg.shape[1]
    if pad:
        seg = torch.cat([seg, seg.new_zeros((b, pad, *x.shape[2:]))], dim=1)
    return seg.reshape(b, 32, k, *x.shape[2:])


def _shift_up(v, off, fill):
    """Lane l takes lane l - off's value (lanes below off: ``fill``)."""
    return torch.cat([fill.expand(v.shape[0], off), v[:, :-off]], dim=1)


def _warp_sum(v):
    """The __shfl_xor_sync butterfly: every lane ends with the same sum."""
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, idx ^ off]
    return v[:, 0]


def _deltas(z):
    b, s = z.shape
    last = torch.full((b, 1), 1e10, dtype=z.dtype)
    return torch.cat([z[:, 1:] - z[:, :-1], last], dim=1)


def _valid(s, s0, k):
    j = s0 + torch.arange(32 * k).reshape(32, k)
    return j < s


def emulate_composite(sigma, z, albedo, sun, sky):
    """-> (weights, transparency, depth, rgb, pre-clip rgb), as the kernel."""
    b, s = sigma.shape
    k = run_length(s)
    one = torch.ones((), dtype=torch.float32)
    w_out, t_out = torch.zeros(b, s), torch.zeros(b, s)
    delta = _deltas(z)
    carry = torch.ones(b)
    acc_d, acc = torch.zeros(b, 32), torch.zeros(b, 32, 3)
    for s0 in range(0, s, 32 * k):
        valid = _valid(s, s0, k)
        sg, zz, sn, dl = (_lanes(x, s0, k) for x in (sigma, z, sun, delta))
        al = _lanes(albedo, s0, k)
        alpha = torch.where(valid, 1.0 - torch.exp(-dl * torch.clamp(sg, min=0.0)), 0.0)
        q = 1.0 - alpha + 1e-10
        prod = torch.ones(b, 32)
        for i in range(k):
            prod = prod * q[..., i]
        incl = prod
        lane = torch.arange(32)
        for off in (1, 2, 4, 8, 16):
            v = _shift_up(incl, off, one)
            incl = torch.where(lane >= off, incl * v, incl)
        excl = _shift_up(incl, 1, one)
        t = carry[:, None] * excl
        carry = carry * incl[:, 31]
        tt, ww = torch.zeros(b, 32, k), torch.zeros(b, 32, k)
        for i in range(k):
            tt[..., i] = t
            ww[..., i] = alpha[..., i] * t
            t = t * q[..., i]
            acc_d = acc_d + ww[..., i] * zz[..., i]
            irr = sn[..., i, None] + (1.0 - sn[..., i, None]) * sky[:, None, :]
            acc = acc + ww[..., i, None] * al[..., i, :] * irr
        n = min(32 * k, s - s0)
        w_out[:, s0:s0 + n] = ww.reshape(b, -1)[:, :n]
        t_out[:, s0:s0 + n] = tt.reshape(b, -1)[:, :n]
    depth = _warp_sum(acc_d)
    pre = torch.stack([_warp_sum(acc[..., c]) for c in range(3)], dim=1)
    return w_out, t_out, depth, torch.clamp(pre, 0.0, 1.0), pre


def emulate_composite_backward(sigma, z, albedo, sun, sky, t, pre, g_w, g_t, g_depth,
                               g_rgb):
    """-> (g_sigma, g_albedo, g_sun, g_sky), as the backward kernel."""
    b, s = sigma.shape
    k = run_length(s, MAX_RUN_BWD)
    seg = 32 * k
    gp = torch.where((pre >= 0.0) & (pre <= 1.0), g_rgb, 0.0)
    delta = _deltas(z)
    g_sigma, g_albedo, g_sun = torch.zeros(b, s), torch.zeros(b, s, 3), torch.zeros(b, s)
    gsky = torch.zeros(b, 32, 3)
    carry = torch.zeros(b)
    lane = torch.arange(32)
    for s0 in range(((s - 1) // seg) * seg, -1, -seg):
        valid = _valid(s, s0, k)
        sg, zz, sn, tt, gw, gt, dl = (_lanes(x, s0, k)
                                      for x in (sigma, z, sun, t, g_w, g_t, delta))
        al = _lanes(albedo, s0, k)
        e = torch.where(valid, torch.exp(-dl * torch.clamp(sg, min=0.0)), 1.0)
        alpha = 1.0 - e
        q = 1.0 - alpha + 1e-10
        wt = alpha * tt
        g = gw + g_depth[:, None, None] * zz
        ga, gs = torch.zeros(b, 32, k, 3), torch.zeros(b, 32, k)
        for c in range(3):
            irr = sn + (1.0 - sn) * sky[:, None, None, c]
            gpc = gp[:, None, None, c]
            g = g + gpc * al[..., c] * irr
            ga[..., c] = gpc * wt * irr
            gs = gs + gpc * wt * al[..., c] * (1.0 - sky[:, None, None, c])
            term = torch.where(valid, gpc * wt * al[..., c] * (1.0 - sn), 0.0)
            for i in range(k):  # summed sample by sample, as the lane does
                gsky[..., c] = gsky[..., c] + term[..., i]
        ck = torch.where(valid, g * alpha + gt, 0.0)
        q = torch.where(valid, q, 1.0)
        de = torch.where(valid & (sg >= 0.0), dl * e, 0.0)
        A, M = torch.zeros(b, 32), torch.ones(b, 32)
        for i in range(k - 1, -1, -1):
            A = q[..., i] * A + ck[..., i]
            M = M * q[..., i]
        for off in (1, 2, 4, 8, 16):
            src = torch.clamp(lane + off, max=31)
            a2, m2 = A[:, src], M[:, src]
            inside = lane + off < 32
            A, M = torch.where(inside, M * a2 + A, A), torch.where(inside, M * m2, M)
        nxt = torch.clamp(lane + 1, max=31)
        r = torch.where(lane == 31, carry[:, None], M[:, nxt] * carry[:, None] + A[:, nxt])
        carry = M[:, 0] * carry + A[:, 0]
        gsig = torch.zeros(b, 32, k)
        for i in range(k - 1, -1, -1):
            gsig[..., i] = tt[..., i] * (g[..., i] - r) * de[..., i]
            r = q[..., i] * r + ck[..., i]
        n = min(seg, s - s0)
        g_sigma[:, s0:s0 + n] = gsig.reshape(b, -1)[:, :n]
        g_albedo[:, s0:s0 + n] = ga.reshape(b, -1, 3)[:, :n]
        g_sun[:, s0:s0 + n] = gs.reshape(b, -1)[:, :n]
    g_sky = torch.stack([_warp_sum(gsky[..., c]) for c in range(3)], dim=1)
    return g_sigma, g_albedo, g_sun, g_sky


def _data(b, s, seed):
    rng = np.random.default_rng(seed)
    sigmas = rng.uniform(-1, 5, (b, s)).astype(np.float32)  # some negative
    sigmas[:1] = -np.abs(sigmas[:1])  # a ray with no density
    if s > 1 and b > 2:
        # a thin ray whose last sample is faint: exp(-1e10 sigma) ~ 1e-13,
        # which 1 - alpha would lose
        sigmas[2] = rng.uniform(0.0, 0.05, s)
        sigmas[2, -1] = 3e-9
    z = np.sort(rng.uniform(0.1, 2.0, (b, s)).astype(np.float32), axis=1)
    albedo = rng.uniform(0, 1, (b, s, 3)).astype(np.float32)
    sun = rng.uniform(0, 1, (b, s)).astype(np.float32)
    sky = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    return sigmas, z, albedo, sun, sky


def _cotangents(b, s, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s), (b, s), (b,), (b, 3))]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _f64_plain(data, cots=None, exact=False):
    """The port's plain version in float64 (outputs, or with ``cots`` the
    gradients of sigmas, albedo, sun, sky), rounded to float32 unless
    ``exact``: the reference at S = 1, where the JAX package's compositing
    returns (B, 0) weights (its last delta is shaped from an empty slice) and
    its Pallas kernel does not trace, and the exact value for long rays."""
    leaves = [torch.from_numpy(a).double().requires_grad_(i != 1) for i, a in enumerate(data)]
    outs = tcomp.composite_reference(*leaves)
    if cots is None:
        res = [o.detach() for o in outs]
    else:
        torch.autograd.backward(outs, [torch.from_numpy(c).double() for c in cots])
        res = [leaves[i].grad for i in (0, 2, 3, 4)]
    return [r.numpy() if exact else r.float().numpy() for r in res]


def _f64_err(a, ref) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.max(np.abs(a.astype(np.float64) - ref))) if a.size else 0.0


@pytest.mark.parametrize("b,s", SHAPES)
def test_emulated_forward_matches_jax_pallas_kernel(b, s, record_property):
    data = _data(b, s, seed=b + s)
    got = emulate_composite(*map(torch.from_numpy, data))
    if s > 32 * MAX_RUN:  # both kernels against the exact value (see _bars)
        jax_out = composite_pallas(*map(jnp.asarray, data), block_b=8, interpret=True)
        exact = _f64_plain(data, exact=True)
        bars = _bars(BARS, s)
        errs = {n: (_f64_err(g, r), _f64_err(j, r))
                for n, g, j, r in zip(BARS, got, jax_out, exact)}
        record_property("err_vs_f64_this_and_jax", errs)
        for name, (mine, theirs) in errs.items():
            assert mine <= bars[name] and theirs <= bars[name], (name, mine, theirs)
        assert torch.equal(torch.clamp(got[4], 0.0, 1.0), got[3])
        return
    if s > 1:
        ref = composite_pallas(*map(jnp.asarray, data), block_b=8, interpret=True)
    else:
        assert jc.convert_sigmas(*map(jnp.asarray, data[:2]))[0].shape == (b, 0)
        ref = _f64_plain(data)
    for name, r, g in zip(BARS, ref, got):
        assert tuple(g.shape) == r.shape, name
        assert max_err(g, np.asarray(r)) <= BARS[name], name
    # the residual is the sum that was clipped
    assert torch.equal(torch.clamp(got[4], 0.0, 1.0), got[3])


@pytest.mark.parametrize("b,s", SHAPES)
def test_emulated_backward_matches_jax_vjp(b, s, record_property):
    data = _data(b, s, seed=2 * b + s)
    cots = _cotangents(b, s, seed=b)
    sigmas, z, albedo, sun, sky = map(jnp.asarray, data)

    def f(sg, alb, sn, sky_s):  # the reference evaluates sky per sample
        w, depth, t, _ = jc.convert_sigmas(sg, z)
        irr = sn[..., None] + (1 - sn[..., None]) * sky_s
        rgb = jnp.clip(jnp.sum(w[..., None] * alb * irr, axis=-2), 0.0, 1.0)
        return w, t, depth, rgb

    if s > 1:
        sky_s = jnp.broadcast_to(sky[:, None, :], (b, s, 3))
        _, vjp = jax.vjp(f, sigmas, albedo, sun, sky_s)
        ref = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cots)))]
        ref[3] = ref[3].sum(axis=1)  # per-ray sky: the sum of the per-sample ones
    else:
        ref = _f64_plain(data, cots)

    tin = [torch.from_numpy(a) for a in data]
    _, t, _, _, pre = emulate_composite(*tin)
    got = emulate_composite_backward(*tin, t, pre, *map(torch.from_numpy, cots))
    bars = _bars(GRAD_BARS, s)
    if s > 32 * MAX_RUN:  # both against the exact gradients (see _bars)
        exact = _f64_plain(data, cots, exact=True)
        errs = {n: (_rel(g.numpy(), e), _rel(r, e))
                for n, g, r, e in zip(GRAD_BARS, got, ref, exact)}
        record_property("rel_err_vs_f64_this_and_jax", errs)
        for name, (mine, theirs) in errs.items():
            assert mine <= bars[name] and theirs <= bars[name], (name, mine, theirs)
        ref = exact
    for name, g, r in zip(GRAD_BARS, got, ref):
        assert g.shape == r.shape, name
        assert _rel(g.numpy(), r) <= bars[name], name
    assert torch.all(got[0][0] == 0.0)  # no density: no gradient to sigma
    if s > 1 and b > 2:  # the faint last sample keeps its gradient
        np.testing.assert_allclose(got[0][2, -1].item(), ref[0][2, -1], rtol=1e-5)
        assert ref[0][2, -1] != 0.0


@pytest.mark.parametrize("b,s", [(77, 64), (4, 300), (4, 1024)])
def test_emulation_matches_the_plain_version(b, s):
    """The emulated kernels against the port's plain version and autograd
    through it, the comparison the card makes (chip_smoke.py), at the bars
    of ``_bars``."""
    data = [torch.from_numpy(a) for a in _data(b, s, seed=7)]
    cots = [torch.from_numpy(c) for c in _cotangents(b, s, seed=8)]
    w, t, depth, rgb, pre = emulate_composite(*data)
    leaves = [x.clone().requires_grad_(i != 1) for i, x in enumerate(data)]
    ref = tcomp.composite_reference(*leaves)
    bars, grad_bars = _bars(BARS, s), _bars(GRAD_BARS, s)
    for name, g, r in zip(BARS, (w, t, depth, rgb), ref):
        assert float((g - r.detach()).abs().max()) <= bars[name], name
    torch.autograd.backward(ref, cots)
    got = emulate_composite_backward(*data, t, pre, *cots)
    for name, g, leaf in zip(GRAD_BARS, got, [leaves[i] for i in (0, 2, 3, 4)]):
        assert float((g - leaf.grad).abs().max()) <= grad_bars[name], name
