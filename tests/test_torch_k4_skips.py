"""The trunk backward K4 with any skip set the JAX kernels take, against the
JAX package on the CPU.

K4's gx launch sums one product per skip beside w0's, and a launch takes at
most ``_bwd.MAX_PRODS`` products; more skips chain launches, each adding
its products to the previous one's f32 sum (its ``add``). At 8 layers with
skips 1-7 (eight products: two launches) and 2, 5 (one launch), both
engines where it matters: the port's plain backward and the kernels' launch
sequence (``torch_parity.emulated_bwd_kernels``) against ``jax.grad``
through the JAX ``fused_trunk`` in interpret mode, within 1e-4 of each
tensor's largest gradient; the gx launches' product counts as the chain
plans them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_tpu.ops.pallas import trunk as jtrunk
from satnerf_torch.models import field as tfield
from satnerf_torch.ops import _bwd, trunk
from satnerf_torch.ops import field_fused as tff
import torch_parity
from torch_parity import emulated_bwd_kernels, field_inputs, field_pair, one_thread

TOL_GRAD = 1e-4  # gradients, relative to each tensor's largest element
N_POINTS = 96


def _rel(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


@functools.lru_cache(maxsize=None)
def _case(skips: tuple):
    """(port spec, port packed f32 trunk, x, cotangent, {JAX gradient}) of an
    8 x 128 trunk with ``skips``; the JAX gradients of sum(h_{L-1} * cot)."""
    kw = dict(variant="rs_semantic", layers=8, feat=128, skips=skips, mapping=True,
              trunk_impl="pallas")
    jcfg, params, tcfg, module = field_pair(**kw)
    jspec = jtrunk.TrunkSpec(layers=8, feat=128, skips=skips, c_in=jcfg.xyz_in)
    enc = np.array(jfield.positional_encoding(jnp.asarray(field_inputs(N_POINTS)[0]),
                                              jcfg.mapping_pos_n_freq))
    cot = np.random.default_rng(len(skips)).normal(size=(N_POINTS, 128)).astype(np.float32)

    def loss(xj, p):
        return jnp.sum(jtrunk.fused_trunk(jspec, True, xj, p) * cot)

    packed_j = jtrunk.pack_trunk(params["trunk"], jspec, jnp.float32)
    gx_j, gp_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(enc), packed_j)
    spec = tfield.fused_field_spec(tcfg)
    want = {k: np.asarray(v) for k, v in gp_j.items()}
    want["w0"], want["w_skip"] = want["w0"][: spec.cx], want["w_skip"][:, : spec.cx]
    want["gx"] = np.asarray(gx_j)[:, : spec.c_in]
    with torch.no_grad():
        packed = trunk.pack_trunk(module, spec, torch.float32)
    x = tff.pack_x(spec, torch.from_numpy(enc), torch.float32)
    return spec, packed, x, torch.from_numpy(cot), want


@pytest.mark.parametrize("skips,bwd", [((1, 2, 3, 4, 5, 6, 7), "recompute"),
                                       ((1, 2, 3, 4, 5, 6, 7), "stored"),
                                       ((2, 5), "recompute")],
                         ids=["skips1-7-recompute", "skips1-7-stored", "skips2-5-recompute"])
def test_k4_any_skip_set_matches_jax(skips, bwd, monkeypatch):
    spec, packed, x, g, want = _case(skips)
    spec = dataclasses.replace(spec, trunk_bwd=bwd)
    gx_prods = []
    row_op = torch_parity._emulated_row_op

    def counting_row_op(lib, fn, dt, rows, width, prods=(), **kw):
        if width in trunk.GX_WIDTHS and kw.get("mode") == _bwd.PLAIN:
            gx_prods.append(len(prods))
        return row_op(lib, fn, dt, rows, width, prods, **kw)

    monkeypatch.setattr(torch_parity, "_emulated_row_op", counting_row_op)
    with one_thread():
        acts = trunk._forward(spec, x, packed, True)[1] if bwd == "stored" else None
        plain = trunk.trunk_backward(spec, x, packed, acts, g)
        with emulated_bwd_kernels():
            launched = trunk._trunk_backward_cuda(spec, x, packed, acts, g, True)
    n_prods = 1 + len(skips)
    assert gx_prods == [min(_bwd.MAX_PRODS, n_prods - i)
                        for i in range(0, n_prods, _bwd.MAX_PRODS)]
    for got in (plain, launched):
        got = dict(zip(("gx",) + trunk.TRUNK_KEYS, got))
        assert _rel(got["gx"][:, : spec.c_in], want["gx"]) < TOL_GRAD, "gx"
        for k in trunk.TRUNK_KEYS:
            assert _rel(got[k], want[k]) < TOL_GRAD, k
