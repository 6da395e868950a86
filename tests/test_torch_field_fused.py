"""satnerf_torch.ops.field_fused (packed raw columns, spec, packing cache)
and the port's Field module layout, against the JAX package.

Raw columns: the plain version of the fused field kernel (what a CPU tensor
runs) against the JAX Pallas kernel in interpret mode, 5e-5 abs in f32 and
0.1 in bf16 (tests/test_pallas_trunk.py:61,78).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_tpu.models.import_torch import torch_state_from_field_params
from satnerf_tpu.ops.pallas import field_fused as jff
from satnerf_tpu.ops.pallas.trunk import TrunkSpec, pack_trunk
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params
from satnerf_torch.ops import field_fused as tff
from torch_parity import (
    field_inputs,
    field_pair,
    jax_field_out,
    max_err,
    torch_field_out,
)


FLAGSHIP = dict(variant="rs_semantic", layers=8, feat=512, skips=(4,), mapping=True)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("port_impl", ["xla", "pallas"])
def test_flagship_8x512_field_matches_jax(port_impl, jax_impl):
    """rs_semantic at its published width (8x512, skip 4, 60 encoded inputs,
    256-wide heads) on 256 points."""
    ref = jax_field_out(dict(FLAGSHIP, trunk_impl=jax_impl), 256)
    got = torch_field_out(dict(FLAGSHIP, trunk_impl=port_impl), 256)
    assert set(got) == set(ref)
    for k in ref:
        assert max_err(got[k], ref[k]) < 5e-5, k


# -- packed raw columns against the JAX Pallas kernel (interpret mode) -------


def _raw_case(dtype: str, heads_on: bool, n: int = 97):
    kw = dict(variant="rs_semantic", layers=4, feat=256, skips=(2,), mapping=True,
              use_tj_for_s=True, trunk_impl="pallas")
    jcfg, params, tcfg, module = field_pair(**kw)
    xyz, sun, view, te, tse = field_inputs(n)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    tspec = TrunkSpec(layers=jcfg.layers, feat=jcfg.feat, skips=tuple(jcfg.skips),
                      c_in=jcfg.xyz_in)
    jspec = jff.FieldSpec(trunk=tspec, fl=jcfg.feat_last, tau=jcfg.t_embedding_tau,
                          n_classes=jcfg.n_classes, has_beta=True, has_semantic=True,
                          use_tj_for_s=True, sep_t_s=False, heads_on=heads_on)
    enc = jfield.positional_encoding(jnp.asarray(xyz), jcfg.mapping_pos_n_freq)
    raw_j = jff.fused_field(
        jspec, True, enc.astype(jdt),
        jff.pack_aux(jspec, jnp.asarray(sun), jnp.asarray(te), None, jdt),
        pack_trunk(params["trunk"], tspec, jdt), jff.pack_heads(params, jspec, jdt),
    )
    raw_j = np.asarray(raw_j)

    spec = dataclasses.replace(tfield.fused_field_spec(tcfg), heads_on=heads_on)
    enc_t = torch.from_numpy(np.array(enc))
    x = tff.pack_x(spec, enc_t, tdt)
    aux = tff.pack_aux(spec, torch.from_numpy(sun), torch.from_numpy(te), None, tdt)
    with torch.no_grad():
        raw_t = tff.fused_field(spec, x, aux, module.packed(tdt))
    return raw_j, raw_t


@pytest.mark.parametrize("heads_on", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_raw_columns_match_jax_kernel(dtype, heads_on):
    raw_j, raw_t = _raw_case(dtype, heads_on)
    out_w = 16  # 9 + 5 classes, rounded up to 16
    assert raw_t.shape == (raw_j.shape[0], out_w)
    assert raw_t.dtype == torch.float32
    assert np.all(raw_j[:, out_w:] == 0.0)
    tol = 5e-5 if dtype == "f32" else 0.1
    assert max_err(raw_t, raw_j[:, :out_w]) < tol
    if not heads_on:  # only sigma and sun_v are evaluated
        live = np.zeros(out_w, bool)
        live[[tff.COL_SIGMA, tff.COL_SUN]] = True
        assert torch.all(raw_t[:, ~torch.from_numpy(live)] == 0)


def test_fused_field_cpu_counts_no_launch():
    before = tff.LAUNCHES
    _raw_case("f32", True, n=9)
    assert tff.LAUNCHES == before


def test_field_spec_counts_flagship_work():
    cfg = tfield.FieldConfig(variant="rs_semantic", mapping=True, trunk_impl="pallas")
    spec = tfield.fused_field_spec(cfg)
    assert (spec.c_in, spec.cx, spec.aux_w) == (60, 60, 12)
    # ~2.82 M multiply-adds and ~5.6 k sines per point at 8x512 / 256 heads
    assert 2.80e6 < spec.mac_per_point() < 2.84e6
    assert spec.sines_per_point() == 8 * 512 + 6 * 256
    assert (spec.out_w, spec.aux_pad) == (16, 16)
    # every width the JAX kernels take (9 + n_classes <= 128, 3 + 2 tau <= 128)
    edge = dataclasses.replace(spec, n_classes=119, tau=62)
    assert (edge.out_w, edge.aux_w, edge.aux_pad) == (128, 128, 128)
    with pytest.raises(ValueError):
        dataclasses.replace(spec, n_classes=120)
    with pytest.raises(ValueError):
        dataclasses.replace(spec, tau=63)


def _csrc(name: str) -> str:
    import os

    with open(os.path.join(os.path.dirname(tff.__file__), "..", "csrc", name)) as f:
        return f.read()


def _width_users() -> dict:
    """{where: (feat, fc_use_full_features)} of every width the JAX package's
    tools default to, its examples train and its pipeline TOMLs set, and the
    port's copies of the tools and examples."""
    import glob
    import os
    import re
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    users = {}
    for fp in sorted(glob.glob(os.path.join(root, "configs", "pipelines", "*.toml"))):
        with open(fp, "rb") as f:
            p = tomllib.load(f)
        users[os.path.basename(fp)] = (p.get("fc_units", 512),
                                       p.get("fc_use_full_features", False))
    for rel in ("tools/four_scenes.py", "tools/ours_train_eval.py",
                "satnerf_torch/tools/four_scenes.py", "satnerf_torch/tools/ours_train_eval.py"):
        with open(os.path.join(root, rel)) as f:
            m = re.search(r'"--units", type=int, default=(\d+)', f.read())
        users[rel] = (int(m.group(1)), False)
    for rel in ("examples/_common.py", "satnerf_torch/examples/_common.py"):
        with open(os.path.join(root, rel)) as f:
            users[rel] = (int(re.search(r"fc_units=(\d+)", f.read()).group(1)), False)
    return users


def test_kernel_widths_match_the_cuda_instantiations():
    # the wrappers admit exactly the widths the CUDA sources take: K1's
    # (feat, feat_last) pairs, K3's trunk widths, K6's one width
    import re

    from satnerf_torch.ops import trunk as ttrunk

    pairs = re.findall(r"a\.feat == (\d+) && a\.fl == (\d+)", _csrc("field_fused.cu"))
    assert sorted((int(a), int(b)) for a, b in pairs) == sorted(tff.KERNEL_WIDTHS)
    ok = re.search(r"inline bool width_ok\(int F\) \{ return ([^;]*);", _csrc("trunk_tc.cuh"))
    feats = sorted(int(w) for w in re.findall(r"F == (\d+)", ok.group(1)))
    assert feats == sorted(ttrunk.FEAT_WIDTHS)
    il = re.search(r"constexpr int kIlFeat = (\d+);", _csrc("trunk_fwd.cu"))
    assert (int(il.group(1)),) == ttrunk.IL_FEAT_WIDTHS
    # K1's heads (K2) and trunk (K4) widths are among the backward's
    assert {fl for _, fl in tff.KERNEL_WIDTHS} <= set(tff.HEADS_BWD_FL)
    assert {f for f, _ in tff.KERNEL_WIDTHS} <= set(ttrunk.FEAT_WIDTHS)
    # every width the JAX tools' defaults, its examples and its pipeline
    # TOMLs use (and the port's copies) reaches a kernel built for it
    users = _width_users()
    assert users["tools/four_scenes.py"] == users["satnerf_torch/tools/four_scenes.py"]
    assert users["examples/_common.py"] == users["satnerf_torch/examples/_common.py"]
    for where, (feat, full) in users.items():
        cfg = tfield.FieldConfig(variant="rs_semantic", feat=feat, mapping=True,
                                 fc_use_full_features=full, trunk_impl="pallas")
        if tfield.use_fused_field(cfg):
            assert (cfg.feat, cfg.feat_last) in tff.KERNEL_WIDTHS, where
        else:
            assert tfield.use_fused_trunk(cfg) and cfg.feat in ttrunk.FEAT_WIDTHS, where


# -- module layout and weight import -------------------------------------------


VARIANT_CFGS = [
    dict(variant="nerf", layers=3, feat=128, skips=(1,), mapping=True, siren=False),
    dict(variant="snerf", layers=3, feat=128, skips=(1,)),
    dict(variant="satnerf", layers=3, feat=128, skips=(1,)),
    dict(variant="rs_semantic", layers=3, feat=128, skips=(1,), mapping=True,
         use_tj_for_s=True, use_separate_beta_for_s=True),
]


@pytest.mark.parametrize("cfg", VARIANT_CFGS, ids=[c["variant"] for c in VARIANT_CFGS])
def test_state_dict_keys_are_the_reference_names(cfg):
    jcfg = jfield.FieldConfig(**cfg)
    params = jfield.init_field_params(jax.random.PRNGKey(0), jcfg)
    ref = torch_state_from_field_params(params, "m")
    module = tfield.Field(tfield.FieldConfig(**cfg))
    sd = module.state_dict()
    assert set(sd) == {k[len("m."):] for k in ref}
    for k, v in ref.items():
        assert sd[k[len("m."):]].shape == v.shape, k
    ours = field_state_from_params(jax.tree.map(np.asarray, params))
    for k, v in ref.items():
        assert torch.equal(ours[k[len("m."):]], v), k


def test_init_bounds_follow_the_reference():
    cfg = tfield.FieldConfig(variant="rs_semantic", layers=3, feat=128, skips=(1,),
                             mapping=True)
    m = tfield.Field(cfg, generator=torch.Generator().manual_seed(0))
    w0 = m.fc_net[0].weight
    assert w0.abs().max() <= 1.0 / 60 and w0.abs().max() > 0.9 / 60
    w1 = m.fc_net[2].weight  # skip layer: fan_in 128 + 60
    assert w1.abs().max() <= np.sqrt(6.0 / 188) and w1.abs().max() > 0.9 * np.sqrt(6.0 / 188)
    w2 = m.fc_net[4].weight
    assert w2.abs().max() <= np.sqrt(6.0 / 128) and w2.abs().max() > 0.9 * np.sqrt(6.0 / 128)
    sv0 = m.sun_v_net[0].weight
    assert sv0.abs().max() <= 1.0 / 131
    feats = m.feats_from_xyz.weight
    assert feats.abs().max() <= 1.0 / np.sqrt(128)
    m2 = tfield.Field(cfg, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))


def test_packed_weights_are_cached_until_a_parameter_changes():
    _, _, tcfg, module = field_pair(variant="snerf", layers=3, feat=256, skips=(1,),
                                    trunk_impl="pallas")
    p1 = module.packed(torch.float32)
    assert module.packed(torch.float32) is p1
    with torch.no_grad():
        module.fc_net[0].bias.add_(1.0)
    p2 = module.packed(torch.float32)
    assert p2 is not p1
    assert torch.equal(p2["b"][0], module.fc_net[0].bias)
