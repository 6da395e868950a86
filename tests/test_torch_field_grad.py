"""Gradients of the port's fused field (K1 residuals -> K2 -> K4, through
``FusedField``) against the JAX package, per packed tensor
(tests/test_torch_field_param_grad.py holds the parameter-level tests).

- The plain K2/K4 backward against ``jax.vjp`` of the Pallas ``fused_field``
  (interpret mode), per packed tensor: f32 within 1e-5 of the largest
  gradient of each tensor, bf16 within 0.1 of it.
- The CUDA wrappers' orchestration of K2 and K4 (workspaces, transposed
  weights, launch order, reductions) run on the CPU with the two kernel
  launches emulated, against the plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_tpu.ops.pallas import field_fused as jff
from satnerf_tpu.ops.pallas.trunk import TrunkSpec, pack_trunk
from satnerf_torch.core.encoding import positional_encoding
from satnerf_torch.models import field as tfield
from satnerf_torch.ops import field_fused as tff
from satnerf_torch.ops import trunk as ttrunk
from torch_parity import emulated_bwd_kernels, field_inputs, field_pair

SMALL = dict(variant="rs_semantic", layers=4, feat=256, skips=(2,), mapping=True)


def _rel(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.detach().float() if isinstance(b, torch.Tensor) else b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# -- the plain backward against jax.vjp of the Pallas kernel -------------------


def _jax_bias_rows(jspec) -> list:
    return list(jspec.hidden_bias_index())


def _to_port_layout(key, g, spec, jspec):
    """A JAX packed gradient (128-lane padded) cut to the port's layout."""
    g = np.asarray(g, np.float32)
    if key in ("w0",):
        return g[: spec.cx]
    if key == "w_skip":
        return g[:, : spec.cx]
    if key in ("w_sv0_aux", "w_sky0_aux", "w_b0_aux", "w_s0_aux"):
        return g[: spec.aux_w]
    if key.startswith("w2_"):
        return g[:, : spec.out_w]
    if key in ("b_small", "b_small_sc"):
        return g[0, : spec.out_w]
    if key == "b_feats":
        return g[0]
    if key == "b_heads":
        out = np.zeros((len(tff.HIDDEN_BIAS_ROWS), spec.fl), np.float32)
        for i, name in enumerate(_jax_bias_rows(jspec)):
            out[tff.HIDDEN_BIAS_ROWS.index(name)] = g[i]
        return out
    return g


@pytest.mark.parametrize("bwd", ["recompute", "stored"])
@pytest.mark.parametrize("heads_on", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_backward_matches_jax_vjp(dtype, heads_on, bwd):
    kw = dict(SMALL, use_tj_for_s=True, trunk_impl="pallas", trunk_bwd=bwd)
    jcfg, params, tcfg, module = field_pair(**kw)
    n = 260
    xyz, sun, _, te, _ = field_inputs(n)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    tspec = TrunkSpec(layers=jcfg.layers, feat=jcfg.feat, skips=tuple(jcfg.skips),
                      c_in=jcfg.xyz_in, bwd=bwd)
    jspec = jff.FieldSpec(trunk=tspec, fl=jcfg.feat_last, tau=jcfg.t_embedding_tau,
                          n_classes=jcfg.n_classes, has_beta=True, has_semantic=True,
                          use_tj_for_s=True, sep_t_s=False, heads_on=heads_on)
    enc = jfield.positional_encoding(jnp.asarray(xyz), jcfg.mapping_pos_n_freq)
    aux_j = jff.pack_aux(jspec, jnp.asarray(sun), jnp.asarray(te), None, jdt)
    pt, ph = pack_trunk(params["trunk"], tspec, jdt), jff.pack_heads(params, jspec, jdt)
    rng = np.random.default_rng(7)
    out_w = tfield.fused_field_spec(tcfg).out_w
    g = np.zeros((n, 128), np.float32)
    g[:, :out_w] = rng.normal(size=(n, out_w))
    _, vjp = jax.vjp(lambda x, a, t, h: jff.fused_field(jspec, True, x, a, t, h),
                     enc.astype(jdt), aux_j, pt, ph)
    gx_j, gaux_j, gt_j, gh_j = vjp(jnp.asarray(g))
    ref = {**gt_j, **gh_j}

    spec = dataclasses.replace(tfield.fused_field_spec(tcfg), heads_on=heads_on)
    x = tff.pack_x(spec, torch.from_numpy(np.array(enc)), tdt).requires_grad_(True)
    aux = tff.pack_aux(spec, torch.from_numpy(sun), torch.from_numpy(te), None, tdt)
    aux.requires_grad_(True)
    packed = {k: v.clone().requires_grad_(True) for k, v in module.packed(tdt).items()}
    keys = tff.TRUNK_KEYS + spec.head_keys()
    out = tff.fused_field(spec, x, aux, packed)
    grads = torch.autograd.grad(out, [x, aux] + [packed[k] for k in keys],
                                torch.from_numpy(g[:, :out_w]))
    bar = 1e-5 if dtype == "f32" else 0.1
    assert _rel(grads[0], np.asarray(gx_j, np.float32)) < bar, "gx"
    assert _rel(grads[1], np.asarray(gaux_j, np.float32)[:, : spec.aux_w]) < bar, "g_aux"
    jkey = {"b_small_sc": "b_small"}
    for key, got in zip(keys, grads[2:]):
        want = _to_port_layout(key, ref[jkey.get(key, key)], spec, jspec)
        assert _rel(got, want) < bar, key


def test_packing_is_differentiable_and_cached_only_without_grad():
    _, _, tcfg, module = field_pair(**dict(SMALL, trunk_impl="pallas"))
    spec = tfield.fused_field_spec(tcfg)
    live = tff.pack_field(module, spec, torch.float32)
    assert all(t.requires_grad for t in live.values())
    assert not any(t.requires_grad for t in module.packed(torch.float32).values())


# -- the CUDA orchestration, with the kernel launches emulated -----------------------


@pytest.mark.parametrize("bwd", ["recompute", "stored"])
@pytest.mark.parametrize("heads_on", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_orchestration_matches_plain(dtype, heads_on, bwd):
    kw = dict(SMALL, use_tj_for_s=True, trunk_impl="pallas", trunk_bwd=bwd)
    _, _, tcfg, module = field_pair(**kw)
    spec = dataclasses.replace(tfield.fused_field_spec(tcfg), heads_on=heads_on)
    n = 70
    xyz, sun, _, te, _ = (torch.from_numpy(a) for a in field_inputs(n))
    x = tff.pack_x(spec, positional_encoding(xyz, 10), dtype)
    aux = tff.pack_aux(spec, sun, te, None, dtype)
    packed = module.packed(dtype)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(n, 16)).astype(np.float32))
    with torch.no_grad():
        _, shared, acts = tff._forward(spec, x, aux, packed, resid=True)
        ref_h = tff.heads_backward_reference(spec, shared, aux, g, packed)
        ref_t = ttrunk.trunk_backward_reference(spec, x, packed, acts, ref_h[0])
        with emulated_bwd_kernels():
            got_h = tff._heads_backward_cuda(spec, shared, aux, g, packed, True)
            got_t = ttrunk._trunk_backward_cuda(spec, x, packed, acts, ref_h[0], True)
    assert _rel(got_h[0], ref_h[0]) < 1e-6 and _rel(got_h[1], ref_h[1]) < 1e-6
    assert set(got_h[2]) == set(ref_h[2]) == set(spec.head_keys())
    for k in ref_h[2]:
        assert _rel(got_h[2][k], ref_h[2][k]) < 1e-6, k
    for name, a, b in zip(("gx", "w0", "w_mid", "w_skip", "b"), got_t, ref_t):
        assert _rel(a, b) < 1e-6, name


def test_backward_wrappers_take_the_plain_path_on_cpu():
    _, _, tcfg, module = field_pair(**dict(SMALL, trunk_impl="pallas"))
    xyz, sun, _, te, _ = (torch.from_numpy(a) for a in field_inputs(33))
    before = (tff.LAUNCHES, tff.HEADS_BWD_LAUNCHES, ttrunk.LAUNCHES)
    plain = (tff.PLAIN_CALLS, ttrunk.PLAIN_CALLS)
    o = tfield.field_forward(module, tcfg, xyz, sun_d=sun, t_emb=te)
    o["sigma"].sum().backward()
    assert (tff.LAUNCHES, tff.HEADS_BWD_LAUNCHES, ttrunk.LAUNCHES) == before
    assert tff.PLAIN_CALLS == plain[0] + 2 and ttrunk.PLAIN_CALLS == plain[1] + 1
