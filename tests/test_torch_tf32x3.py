"""The 3xTF32 products of the f32 backward kernels (csrc/bwd_common.cuh), in
their plain PyTorch emulation (satnerf_torch/ops/_bwd.py): tf32 rounding,
the hi/lo split and lo*hi + hi*lo + hi*hi, against f32 and f64 products and
against the JAX package's f32 VJP of one trunk layer at flagship widths.

Bars: 3xTF32 keeps about 22 significant bits, so a K-term product lands
within a few f32 roundings of the f64 one; over max |f64| it reads up to
5.2e-7 here (an f32 product: 6.4e-7), and 2e-6 is the bar. Against JAX's f32 VJP both sides add their own
f32 rounding; the bar is 1e-5, ten times below the card's 1e-4 bar for the
backward kernels against their plain versions (chip_smoke.py
TOL_FIELD_BWD). One TF32 pass (11 bits) misses that 1e-4 bar (2.5e-4).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_torch.ops import _bwd

torch.set_num_threads(2)

TOL_F64 = 2e-6
TOL_JAX = 1e-5
TOL_FIELD_BWD = 1e-4  # chip_smoke.py: kernel vs plain, f32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _randn(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_randn(rng, 4096, scale=10.0))
    hi = _bwd.tf32_round(x)
    bits = hi.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    # within half a tf32 ulp (2^-11 of the value) and never a closer tf32 value
    assert torch.all((x.double() - hi.double()).abs() <= 2.0 ** -11 * x.double().abs())
    # exact ties round away from zero: 1 + 2^-11 lies halfway between tf32 values
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert _bwd.tf32_round(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_split_keeps_22_bits():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_randn(rng, 4096, scale=3.0))
    hi, lo = _bwd.split_tf32(x)
    assert torch.equal(hi, _bwd.tf32_round(hi)) and torch.equal(lo, _bwd.tf32_round(lo))
    err = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0 ** -21 * x.double().abs())


@pytest.mark.parametrize("n,k,m", [(256, 512, 512), (256, 64, 512), (256, 512, 16),
                                   (256, 16, 256)])
def test_3xtf32_product_matches_f64(n, k, m):
    rng = np.random.default_rng(n + k + m)
    a, b = _randn(rng, n, k), _randn(rng, k, m, scale=0.05)
    got = _bwd.matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(got, ref) < TOL_F64
    f32 = torch.from_numpy(a) @ torch.from_numpy(b)
    assert _rel(got, f32) < TOL_F64


def _layer_case(first: bool, n: int = 256, feat: int = 512, c_in: int = 60):
    """One SIREN trunk layer at flagship widths: layer 0 (60 inputs, w0 30)
    or a 512 -> 512 middle layer; its input, weights and output gradient."""
    rng = np.random.default_rng(7 if first else 8)
    fan_in = c_in if first else feat
    h = _randn(rng, n, fan_in) if first else np.sin(_randn(rng, n, fan_in))
    bound = 1.0 / fan_in if first else np.sqrt(6.0 / fan_in) / 30.0
    w = rng.uniform(-bound, bound, (fan_in, feat)).astype(np.float32)
    b = _randn(rng, feat, scale=0.1)
    g = _randn(rng, n, feat)
    return h, w, b, g


@pytest.mark.parametrize("first", [True, False])
def test_3xtf32_layer_vjp_matches_jax(first):
    """gx and gW of sin(w0 (h W + b)) through 3xTF32 products (the kernels'
    arithmetic, the input padded to 64 columns as K4 pads it) against
    jax.vjp of the JAX package's layer in f32."""
    h, w, b, g = _layer_case(first)
    cfg = types.SimpleNamespace(siren=True, sin_impl="exact")

    def layer(h_, w_):
        return jfield._act(cfg, jfield._linear({"w": w_, "b": jnp.asarray(b)}, h_), first)

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(layer, jnp.asarray(h), jnp.asarray(w))
        jgx, jgw = (np.asarray(t) for t in vjp(jnp.asarray(g)))

    w0 = 30.0 if first else 1.0
    kx = _bwd.padded_k(h.shape[1])
    ht = _bwd.pad_cols(torch.from_numpy(h), kx)
    wt = torch.nn.functional.pad(torch.from_numpy(w), (0, 0, 0, kx - w.shape[0]))
    a = _bwd.matmul_3xtf32(ht, wt) + torch.from_numpy(b)
    ga = torch.from_numpy(g) * torch.cos(w0 * a) * w0
    gx = _bwd.matmul_3xtf32(ga, wt.t())[:, : h.shape[1]]
    gw = _bwd.matmul_3xtf32(ht.t(), ga)[: h.shape[1]]
    assert _rel(gx, jgx) < TOL_JAX
    assert _rel(gw, jgw) < TOL_JAX


def test_one_tf32_pass_misses_the_f32_bar():
    """Why three passes: hi*hi alone (plain TF32) is off by 2.5e-4 at K 512."""
    a, w, _, _ = _layer_case(False)
    one = _bwd.tf32_round(torch.from_numpy(a)) @ _bwd.tf32_round(torch.from_numpy(w))
    three = _bwd.matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(w))
    ref = a.astype(np.float64) @ w.astype(np.float64)
    assert _rel(one, ref) > TOL_FIELD_BWD > 100 * _rel(three, ref)
