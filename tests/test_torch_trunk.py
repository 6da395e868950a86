"""The port's trunk-only kernel K3 (``ops/trunk.py``: ``fused_trunk``, its
plain version, ``FusedTrunk``) and the RS-Semantic ablation fields that run
it, against the JAX package.

- ``fused_trunk_reference`` against the Pallas ``fused_trunk`` (interpret
  mode) on the same packed weights: f32 within 5e-5 (the repo's bar between
  two field engines, tests/test_pallas_trunk.py:61), bf16 within 0.1 (:78);
  the "stored" pre-activations against ``_trunk_fwd_call(emit_acts=True)``.
- ``FusedTrunk`` gradients, both backward engines, against ``jax.grad``
  through ``fused_trunk``: within 1e-4 of each tensor's largest gradient.
- The two ablation fields (``use_tj_instead_of_beta``,
  ``use_separate_beta_for_s``) with ``trunk_impl="pallas"``: outputs with
  ``n_full`` within 5e-5 of JAX's pallas path, and the parameter gradients
  of a weighted sum of every output within 1e-4 of each tensor's largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_tpu.ops.pallas import trunk as jtrunk
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params
from satnerf_torch.ops import field_fused as tff
from satnerf_torch.ops import trunk as ttrunk
from torch_parity import field_inputs, field_pair, max_err

SMALL = dict(variant="rs_semantic", layers=3, feat=128, skips=(1,), mapping=True)
FLAGSHIP = dict(variant="rs_semantic", layers=8, feat=512, skips=(4,), mapping=True)
ABLATIONS = ("use_tj_instead_of_beta", "use_separate_beta_for_s")


def _rel(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


@functools.lru_cache(maxsize=None)
def _setup(kw: tuple, n: int, bwd: str = "recompute"):
    """(JAX spec, JAX params, port spec, port module, encoded points)."""
    kw = dict(kw, trunk_impl="pallas", trunk_bwd=bwd)
    jcfg, params, tcfg, module = field_pair(**kw)
    jspec = jtrunk.TrunkSpec(layers=jcfg.layers, feat=jcfg.feat, skips=tuple(jcfg.skips),
                             c_in=jcfg.xyz_in, bwd=bwd)
    xyz = field_inputs(n)[0]
    enc = np.array(jfield.positional_encoding(jnp.asarray(xyz), jcfg.mapping_pos_n_freq))
    return jspec, params, tfield.fused_field_spec(tcfg), module, enc


def _port_inputs(spec, module, enc, dt):
    return tff.pack_x(spec, torch.from_numpy(enc), dt), ttrunk.pack_trunk(module, spec, dt)


@pytest.mark.parametrize("case,dtype", [("small", "f32"), ("small", "bf16"),
                                        ("flagship", "f32")])
def test_fused_trunk_reference_matches_pallas(case, dtype):
    kw, n = (SMALL, 150) if case == "small" else (FLAGSHIP, 300)
    jspec, params, spec, module, enc = _setup(tuple(kw.items()), n)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    packed_j = jtrunk.pack_trunk(params["trunk"], jspec, jdt)
    ref = jtrunk.fused_trunk(jspec, True, jnp.asarray(enc).astype(jdt), packed_j)
    ref_out, ref_acts = jtrunk._trunk_fwd_call(jspec, True, jnp.asarray(enc).astype(jdt),
                                               packed_j, emit_acts=True)
    x, packed = _port_inputs(spec, module, enc, tdt)
    before = ttrunk.FWD_PLAIN_CALLS
    with torch.no_grad():
        out = ttrunk.fused_trunk(spec, x, packed)
        out2, acts = ttrunk.fused_trunk_reference(spec, x, packed, emit_acts=True)
    assert ttrunk.FWD_PLAIN_CALLS == before + 2
    assert out.dtype == tdt and out.shape == (n, spec.feat)
    assert acts.shape == (spec.layers, n, spec.feat) and acts.dtype == tdt
    assert torch.equal(out, out2)
    bar = 5e-5 if dtype == "f32" else 0.1
    assert max_err(out, np.asarray(ref.astype(jnp.float32))) < bar
    assert max_err(out, np.asarray(ref_out.astype(jnp.float32))) < bar
    # the TPU kernel keeps a padded tail of rows; the port writes exactly n
    ref_acts = np.asarray(ref_acts.astype(jnp.float32))[:, :n]
    assert _rel(acts, ref_acts) < (5e-5 if dtype == "f32" else 0.1)


@pytest.mark.parametrize("bwd", ["recompute", "stored"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_trunk_grads_match_jax(bwd, dtype):
    n = 140
    jspec, params, spec, module, enc = _setup(tuple(SMALL.items()), n, bwd)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    cot = np.random.default_rng(5).normal(size=(n, spec.feat)).astype(np.float32)
    packed_j = jtrunk.pack_trunk(params["trunk"], jspec, jdt)

    def loss(x, p):
        out = jtrunk.fused_trunk(jspec, True, x, p).astype(jnp.float32)
        return jnp.sum(out * cot)

    gx_j, gp_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(enc).astype(jdt), packed_j)
    x, packed = _port_inputs(spec, module, enc, tdt)
    x.requires_grad_(True)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in packed.items()}
    out = ttrunk.fused_trunk(spec, x, leaves)
    assert out.grad_fn is not None and "FusedTrunk" in type(out.grad_fn).__name__
    before = ttrunk.PLAIN_CALLS
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert ttrunk.PLAIN_CALLS == before + 1
    bar = 1e-4 if dtype == "f32" else 0.1
    cx, c_in = spec.cx, spec.c_in
    assert _rel(x.grad[:, :c_in], np.asarray(gx_j.astype(jnp.float32))) < bar, "gx"
    want = {k: np.asarray(v.astype(jnp.float32)) for k, v in gp_j.items()}
    want["w0"], want["w_skip"] = want["w0"][:cx], want["w_skip"][:, :cx]
    for k in ttrunk.TRUNK_KEYS:
        assert _rel(leaves[k].grad, want[k]) < bar, k


def test_pack_trunk_is_the_fused_fields_trunk_and_differentiable():
    _, _, spec, module, _ = _setup(tuple(SMALL.items()), 8)
    live = ttrunk.pack_trunk(module, spec, torch.float32)
    full = tff.pack_field(module, spec, torch.float32)
    assert set(live) == set(ttrunk.TRUNK_KEYS)
    for k in ttrunk.TRUNK_KEYS:
        assert live[k].requires_grad and torch.equal(live[k], full[k]), k
    cfg = tfield.FieldConfig(**dict(SMALL, trunk_impl="pallas",
                                    use_separate_beta_for_s=True))
    field = tfield.Field(cfg)
    cached = field.packed(torch.float32)
    assert set(cached) == set(ttrunk.TRUNK_KEYS)
    assert not any(t.requires_grad for t in cached.values())
    assert field.packed(torch.float32) is cached


# -- the ablation fields (K3 + layer-by-layer heads) -----------------------------


@functools.lru_cache(maxsize=None)
def _ablation(flag: str):
    kw = dict(SMALL, use_separate_tj_for_semantic=True, **{flag: True})
    jcfg_x, params, _, _ = field_pair(**kw)
    jcfg = jfield.FieldConfig(**dict(kw, trunk_impl="pallas"))
    tcfg = tfield.FieldConfig(**dict(kw, trunk_impl="pallas"))
    module = tfield.Field(tcfg)
    module.load_state_dict(field_state_from_params(params))
    return jcfg, params, tcfg, module


@pytest.mark.parametrize("flag", ABLATIONS)
def test_ablation_field_forward_through_k3_matches_jax(flag):
    jcfg, params, tcfg, module = _ablation(flag)
    assert tfield.use_fused_trunk(tcfg) and not tfield.use_fused_field(tcfg)
    n, nf = 120, 90
    xyz, sun, _, te, tse = field_inputs(n)
    ref = jfield.field_forward(params, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
                               t_emb=jnp.asarray(te), t_s_emb=jnp.asarray(tse), n_full=nf)
    before = ttrunk.FWD_PLAIN_CALLS
    with torch.no_grad():
        got = module(torch.from_numpy(xyz), sun_d=torch.from_numpy(sun),
                     t_emb=torch.from_numpy(te), t_s_emb=torch.from_numpy(tse), n_full=nf)
    assert ttrunk.FWD_PLAIN_CALLS == before + 1  # one trunk call over all n points
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert max_err(got[k], np.asarray(ref[k])) < 5e-5, k


@pytest.mark.parametrize("bwd", ["recompute", "stored"])
@pytest.mark.parametrize("flag", ABLATIONS)
def test_ablation_field_grads_through_k3_match_jax(flag, bwd):
    jcfg, params, tcfg, module = _ablation(flag)
    jcfg = jfield.FieldConfig(**{**jcfg.__dict__, "trunk_bwd": bwd})
    tcfg = tfield.FieldConfig(**{**tcfg.__dict__, "trunk_bwd": bwd})
    n, nf = 100, 70
    xyz, sun, _, te, tse = field_inputs(n)
    rng = np.random.default_rng(11)

    def weights(out):
        return {k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in out.items()}

    probe = jfield.field_forward(params, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
                                 t_emb=jnp.asarray(te), t_s_emb=jnp.asarray(tse), n_full=nf)
    cots = weights(probe)

    def jloss(p):
        out = jfield.field_forward(p, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
                                   t_emb=jnp.asarray(te), t_s_emb=jnp.asarray(tse),
                                   n_full=nf)
        return sum(jnp.sum(out[k] * cots[k]) for k in out)

    want = field_state_from_params(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    out = tfield.field_forward(module, tcfg, torch.from_numpy(xyz),
                               sun_d=torch.from_numpy(sun), t_emb=torch.from_numpy(te),
                               t_s_emb=torch.from_numpy(tse), n_full=nf)
    module.zero_grad()
    sum((out[k] * torch.from_numpy(cots[k])).sum() for k in out).backward()
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k].numpy()) <= 1e-4, k
