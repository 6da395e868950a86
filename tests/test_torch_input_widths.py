"""The port at every encoded-input width the JAX kernels take past 64 (c_in
up to 128), against the JAX package on the CPU.

- The field (``field_forward`` with ``trunk_impl="pallas"``) at
  mapping_pos_n_freq 11, 12, 16 and 21 (c_in 66, 72, 96 and 126; 80, 80, 96
  and 128 after padding to 16) on both routes: rs_semantic at 128 x 128
  runs the fused field (K1, K2, K4; their plain versions here), at 128 x 64
  the trunk kernel with the heads layer by layer (K3, K4), as the JAX
  package runs its Pallas ``fused_field`` / ``fused_trunk`` in interpret
  mode. Three layers, a skip at 1, 200 points, weights drawn from a numpy
  seed (``test_torch_widths.field_matches_jax``). Bars (ROADMAP): outputs
  within 5e-5 abs in f32; every parameter gradient and the t-embedding's
  within 1e-4 of its tensor's largest element.
- Both packages route 10 to 22 frequencies alike: up to 21 (c_in <= 128,
  the JAX kernels' ``c_in <= LANE``) to the kernels, whose ``TC_MAX_K``
  holds the padded width; 22 (c_in 132) to the layer-by-layer field.
- The tensor-core forward's dataflow (``test_torch_field_tc.emulate_field``:
  3xTF32 products on the prepared weights, K padded to 16) at padded x
  widths 80 and 128, against the JAX fused field and trunk kernels in
  interpret mode at flagship widths (8 x 512, skip at 4): 5e-5 in f32
  (tests/test_pallas_trunk.py:61).
- The wrappers' limits are those of the CUDA sources.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_field_tc as field_tc
import test_torch_widths as widths
from satnerf_tpu.models import field as jfield
from satnerf_tpu.ops.pallas.trunk import TrunkSpec, fused_trunk, pack_trunk
from satnerf_torch.models import field as tfield
from satnerf_torch.ops import _bwd, trunk
from satnerf_torch.ops import field_fused as tff
from torch_parity import field_inputs, max_err

torch.set_num_threads(2)

FREQS = (11, 12, 16, 21)  # c_in 66, 72, 96, 126
ROUTES = {"k1": (128, 128), "k3": (128, 64)}  # (feat, feat_last)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("n_freq", FREQS)
def test_field_at_input_width_matches_jax(n_freq, route):
    feat, fl = ROUTES[route]
    kw = dict(widths._kw(feat, fl), mapping_pos_n_freq=n_freq)
    tcfg = widths.field_matches_jax(kw)
    assert tcfg.xyz_in == 6 * n_freq
    assert tfield.use_fused_field(tcfg) == (route == "k1")
    assert tfield.use_fused_trunk(tcfg) == (route == "k3")


@pytest.mark.parametrize("n_freq", range(10, 23))
def test_both_packages_route_each_input_width_alike(n_freq):
    """The port's routing is the JAX package's at every frequency count from
    10 to 22, and the kernels of the route take the padded width."""
    for feat, fl in ROUTES.values():
        kw = dict(widths._kw(feat, fl), mapping_pos_n_freq=n_freq)
        jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
        assert tcfg.xyz_in == jcfg.xyz_in == 6 * n_freq
        fused = jfield._use_pallas_field(jcfg)
        assert tfield.use_fused_field(tcfg) == fused
        assert tfield.use_fused_trunk(tcfg) == (jfield._use_pallas_trunk(jcfg) and not fused)
        on_kernels = tfield.use_fused_field(tcfg) or tfield.use_fused_trunk(tcfg)
        assert on_kernels == (n_freq <= 21)
        spec = tfield.fused_field_spec(tcfg)
        assert (_bwd.padded_k(spec.cx) <= trunk.TC_MAX_K) == on_kernels


@pytest.mark.parametrize("n_freq,kx", [(12, 80), (21, 128)])
def test_emulated_kernel_at_wide_input_matches_jax_kernels(n_freq, kx):
    """K1's and K3's arithmetic (the emulation) at an x tile ``kx`` wide
    against the JAX fused field and trunk kernels in interpret mode, f32,
    8 x 512 with 256-wide heads, and against the port's plain version."""
    raw_j, out, (spec, x, aux, packed, shared, acts) = field_tc._case(
        "f32", True, False, mapping_pos_n_freq=n_freq)
    assert spec.c_in == 6 * n_freq and _bwd.padded_k(spec.cx) == kx
    assert tff.tc_weights(packed)["w0"].shape[-3] * 8 == kx  # k-steps of 8 f32
    assert max_err(out, raw_j) < 5e-5
    ref, ref_shared, ref_acts = tff._reference_forward(
        dataclasses.replace(spec, trunk_bwd="stored"), x, aux, packed, True)
    assert max_err(out, ref.numpy()) < 5e-5
    assert max_err(shared, ref_shared.numpy()) < 5e-5
    assert max_err(acts, ref_acts.numpy()) < 5e-5 * max(1.0, float(ref_acts.abs().max()))

    jcfg, params, _, _ = field_tc.field_pair(**field_tc.FLAGSHIP, mapping_pos_n_freq=n_freq)
    xyz = field_inputs(field_tc.N_POINTS)[0]
    tspec = TrunkSpec(layers=jcfg.layers, feat=jcfg.feat, skips=tuple(jcfg.skips),
                      c_in=jcfg.xyz_in)
    enc = jfield.positional_encoding(jnp.asarray(xyz), n_freq)
    ref_trunk = np.asarray(fused_trunk(tspec, True, enc, pack_trunk(params["trunk"], tspec,
                                                                    jnp.float32)))
    assert max_err(shared, ref_trunk[:, : spec.feat]) < 5e-5


def test_input_width_limits_match_the_cuda_sources():
    """The wrappers' limits are the CUDA sources': K1/K3's widest x tile
    (csrc/trunk_tc.cuh kMaxX) is TC_MAX_K, 128, the widest padded c_in the
    JAX kernels take; K6's (csrc/trunk_ws.cuh) is IL_MAX_K; the gx launch
    of K4 covers both (GX_WIDTHS)."""
    csrc = os.path.join(os.path.dirname(trunk.__file__), os.pardir, "csrc")

    def max_x(name):
        with open(os.path.join(csrc, name)) as f:
            return int(re.search(r"constexpr int kMaxX = (\d+);", f.read()).group(1))

    assert max_x("trunk_tc.cuh") == trunk.TC_MAX_K == _bwd.padded_k(126) == 128
    assert max_x("trunk_ws.cuh") == trunk.IL_MAX_K == 64
    assert max(trunk.GX_WIDTHS) >= trunk.TC_MAX_K
