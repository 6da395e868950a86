"""satnerf_torch.models.field against the JAX field (field_forward).

The same weights (JAX ``init_field_params``, carried over by
``field_state_from_params``) and the same seeded inputs go through both.
Each port engine ("xla": layer by layer; "pallas": the fused kernel's plain
version on the CPU) is held against each JAX engine ("xla", and "pallas" in
interpret mode). Bars: 5e-5 abs in f32 (tests/test_pallas_trunk.py:61),
0.1 in bf16 (:78). The flagship 8x512 case is in test_torch_field_fused.py;
the trunk-only kernel's ablation fields in test_torch_trunk.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_torch.models import field as tfield
from torch_parity import (
    field_inputs,
    field_pair,
    jax_field_out,
    max_err,
    torch_field_out,
)

TOL = {None: 5e-5, "bf16": 0.1}

# name -> (config kwargs, n points, n_full, compute dtype)
CASES = {
    "rs_semantic_4x256_tj_for_s_logits_nfull": (
        dict(variant="rs_semantic", layers=4, feat=256, skips=(2,), mapping=True,
             use_tj_for_s=True, semantic_sigmoid=False), 300, 200, None),
    "rs_semantic_4x256_sep_t_s": (
        dict(variant="rs_semantic", layers=4, feat=256, skips=(2,), mapping=True,
             use_tj_for_s=True, use_separate_tj_for_semantic=True), 160, None, None),
    "rs_semantic_4x256_bf16": (
        dict(variant="rs_semantic", layers=4, feat=256, skips=(2,), mapping=True),
        300, None, "bf16"),
    "satnerf_3x256": (dict(variant="satnerf", layers=3, feat=256, skips=(1,)),
                      130, None, None),
    "snerf_3x256_nfull": (dict(variant="snerf", layers=3, feat=256, skips=(1,)),
                          130, 100, None),
}


def _jax_out(case: str, impl: str):
    kw, n, nf, dt = CASES[case]
    return jax_field_out(dict(kw, trunk_impl=impl), n, nf, dt)


def _torch_out(case: str, impl: str):
    kw, n, nf, dt = CASES[case]
    return torch_field_out(dict(kw, trunk_impl=impl), n, nf, dt)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("port_impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_field_matches_jax(case, port_impl, jax_impl):
    ref = _jax_out(case, jax_impl)
    got = _torch_out(case, port_impl)
    assert set(got) == set(ref)
    tol = TOL[CASES[case][3]]
    for k in ref:
        assert got[k].dtype == torch.float32, k
        assert max_err(got[k], ref[k]) < tol, (k, max_err(got[k], ref[k]))


@functools.lru_cache(maxsize=None)
def _nerf_ref():
    kw = dict(variant="nerf", layers=3, feat=128, skips=(1,), mapping=True,
              siren=False)
    jcfg, params, tcfg, module = field_pair(**kw)
    xyz, sun, view, te, tse = field_inputs(150)
    ref = jfield.field_forward(params, jcfg, jnp.asarray(xyz),
                               view_dir=jnp.asarray(view))
    with torch.no_grad():
        got = module(torch.from_numpy(xyz), view_dir=torch.from_numpy(view))
    return ref, got


@pytest.mark.parametrize("key", ["sigma", "rgb"])
def test_nerf_relu_view_dir_matches_jax(key):
    ref, got = _nerf_ref()
    assert set(ref) == set(got) == {"sigma", "rgb"}
    assert max_err(got[key], np.asarray(ref[key])) < 5e-5


@pytest.mark.parametrize("flag", ["use_tj_instead_of_beta", "use_separate_beta_for_s"])
def test_unfused_semantic_options_match_jax(flag):
    kw = dict(variant="rs_semantic", layers=3, feat=256, skips=(1,), mapping=True,
              use_separate_tj_for_semantic=True, **{flag: True})
    jcfg, params, tcfg, module = field_pair(**kw)
    xyz, sun, view, te, tse = field_inputs(120)
    ref = jfield.field_forward(params, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
                               t_emb=jnp.asarray(te), t_s_emb=jnp.asarray(tse),
                               n_full=90)
    with torch.no_grad():
        got = module(torch.from_numpy(xyz), sun_d=torch.from_numpy(sun),
                     t_emb=torch.from_numpy(te), t_s_emb=torch.from_numpy(tse),
                     n_full=90)
    assert set(got) == set(ref)
    for k in ref:
        assert max_err(got[k], np.asarray(ref[k])) < 5e-5, k


def test_pallas_on_unfused_config_raises():
    """trunk_impl="pallas" outside the fused field, which once raised, takes
    the trunk-only kernel's path (its plain version on the CPU), never a
    silent layer-by-layer fallback; the kernel wrapper raises on a device it
    cannot launch on (the name is kept so that the test's history stays
    one)."""
    from satnerf_torch.ops import trunk as ttrunk

    kw = dict(variant="rs_semantic", layers=3, feat=256, skips=(1,), mapping=True,
              use_tj_instead_of_beta=True, trunk_impl="pallas")
    _, _, tcfg, module = field_pair(**kw)
    assert not tfield.use_fused_field(tcfg) and tfield.use_fused_trunk(tcfg)
    xyz, sun, view, te, _ = (torch.from_numpy(a) for a in field_inputs(8))
    before = ttrunk.FWD_PLAIN_CALLS
    with torch.no_grad():
        module(xyz, sun_d=sun, t_emb=te)
    assert ttrunk.FWD_PLAIN_CALLS == before + 1
    spec = tfield.fused_field_spec(tcfg)
    meta = torch.empty((8, spec.cx), device="meta")
    with pytest.raises(ValueError):
        ttrunk.fused_trunk(spec, meta, module.packed(torch.float32))
