"""The port at trunk widths 640-1,024 and with any skip set, against the JAX
package on the CPU.

- The field (``field_forward`` with ``trunk_impl="pallas"``) at (640, 320),
  (768, 384) and (1,024, 512): the last two run the fused field (K1, K2, K4;
  their plain versions here), 640 the trunk kernel with the heads layer by
  layer (K3, K4), as the JAX package runs its Pallas ``fused_field`` /
  ``fused_trunk`` in interpret mode. Three layers, a skip at 1, 200 points,
  weights drawn from a numpy seed and carried into both packages by
  ``models/import_params.py`` (``test_torch_widths.field_matches_jax``).
  Bars (ROADMAP): every output within 5e-5 abs in f32; every parameter
  gradient and the t-embedding's within 1e-4 of its tensor's largest
  element.
- Both packages send each width to the same kernel, the port's width lists
  hold it, and both refuse heads wider than the JAX fused field's 512
  (fc_use_full_features past 512, a trunk past 1,024): JAX asserts, the
  port raises ValueError.
- The tensor-core forward's weight layout at each new width: every sampled
  element where csrc/trunk_tc.cuh reads it (the passes of 256 columns, then
  the 128-column one at 640 and 896).

``test_torch_widths.numpy_pair`` scales each numpy draw by the largest
value of the JAX initialisation; here by the bound that initialisation
draws within (``_linear_init``'s U(+-bound)), read from
``init_field_params`` with its uniform draws replaced by their bound, so
that no JAX program is compiled for the weights and the file stays within
30 s.
"""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params
from satnerf_torch.ops import trunk
from satnerf_torch.ops import field_fused as tff
import test_torch_widths as widths
from torch_parity import field_inputs

WIDE = [(640, 320), (768, 384), (896, 448), (1024, 512)]


def _bound(key, shape, dtype, minval, maxval):
    return np.full(shape, maxval, np.float32)


def _numpy_pair(kw: dict, seed: int = 0):
    """test_torch_widths.numpy_pair's pair, each tensor drawn uniformly from
    a numpy generator within its JAX initialisation's bound."""
    jcfg = jfield.FieldConfig(**kw)
    with unittest.mock.patch.object(jax.random, "uniform", _bound):
        bounds = jfield.init_field_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.uniform(-1.0, 1.0, a.shape) * a.max()).astype(np.float32), bounds)
    tcfg = tfield.FieldConfig(**kw)
    module = tfield.Field(tcfg)
    module.load_state_dict(field_state_from_params(params))
    return jcfg, params, tcfg, module


@pytest.fixture(autouse=True)
def _bounded_init(monkeypatch):
    monkeypatch.setattr(widths, "numpy_pair", _numpy_pair)


@pytest.mark.parametrize("feat,fl", [(640, 320), (768, 384), (1024, 512)],
                         ids=["640x320", "768x384", "1024x512"])
def test_wide_field_matches_jax(feat, fl):
    tcfg = widths.field_matches_jax(widths._kw(feat, fl))
    assert tcfg.feat_last == fl


@pytest.mark.parametrize("feat,fl", WIDE, ids=[f"{a}x{b}" for a, b in WIDE])
def test_both_packages_route_each_wide_width_alike(feat, fl):
    """The port's use_fused_field / use_fused_trunk are the JAX package's at
    each width, and the route's kernels take it: K1 and K2 (KERNEL_WIDTHS,
    HEADS_BWD_FL) at 768 and 1,024, K3 and K4 (FEAT_WIDTHS) at all four."""
    kw = widths._kw(feat, fl)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    assert tcfg.feat_last == jcfg.feat_last == fl
    fused = jfield._use_pallas_field(jcfg)
    assert tfield.use_fused_field(tcfg) == fused == (fl % 128 == 0)
    assert tfield.use_fused_trunk(tcfg) == (jfield._use_pallas_trunk(jcfg) and not fused)
    assert feat in trunk.FEAT_WIDTHS and feat > trunk.SMEM_MAX_FEAT
    if fused:
        assert (feat, fl) in tff.KERNEL_WIDTHS and fl in tff.HEADS_BWD_FL
        assert tfield.fused_field_spec(tcfg).fl == fl


@pytest.mark.parametrize("feat,fl", [(1024, 1024), (640, 640), (1280, 640)],
                         ids=["1024x1024", "640x640", "1280x640"])
def test_both_packages_refuse_heads_past_512(feat, fl):
    """Where the JAX fused field would take heads wider than 512 (its
    FieldSpec asserts fl <= 512), the port raises ValueError naming the
    widths it takes, on the CPU as on the card."""
    kw = dict(widths._kw(feat, fl), layers=2)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    assert jfield._use_pallas_field(jcfg) and tfield.use_fused_field(tcfg)
    module = tfield.Field(tcfg)
    xyz, sun, _, te, _ = field_inputs(8)
    with pytest.raises(AssertionError):  # its FieldSpec, before any weight is read
        jfield.field_forward({}, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun),
                             t_emb=jnp.asarray(te))
    with pytest.raises(ValueError, match=r"heads up to 512 wide .*\(1024, 512\)"):
        tfield.field_forward(module, tcfg, torch.from_numpy(xyz), sun_d=torch.from_numpy(sun),
                             t_emb=torch.from_numpy(te))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat,fl", WIDE, ids=[f"{a}x{b}" for a, b in WIDE])
def test_wide_layout_is_where_the_kernel_reads(dtype, feat, fl, monkeypatch):
    """tc_weights at the new widths: W^T of each weight pass after pass
    (three or four of 256 rows, then 128 at 640 and 896), each k-step a
    swizzled (rows, 32-byte) tile; the 16-row projections k-step after
    k-step (test_torch_widths' check, which samples 64 elements a weight;
    on the port's own initialisation, the layout being the same for any
    values)."""
    def port_only(kw, seed=0):
        tcfg = tfield.FieldConfig(**kw)
        return None, None, tcfg, tfield.Field(tcfg, generator=torch.Generator().manual_seed(seed))

    monkeypatch.setattr(widths, "numpy_pair", port_only)
    widths.test_tail_pass_layout_is_where_the_kernel_reads(dtype, feat, fl)


# the JAX kernels' VMEM: every operand of their ``pl.pallas_call`` is a
# VMEM block, the weights whole (satnerf_tpu/ops/pallas/trunk.py
# ``_trunk_fwd_call`` :347, ``_fused_trunk_bwd`` :404; field_fused.py
# ``_fwd_call`` :375, ``_fused_field_bwd`` :579); Pallas keeps two buffers of
# each block and one of each scratch array, under the kernels'
# ``vmem_limit_bytes`` of 64 MiB. Values the kernel body keeps live beside
# them are not counted, so a width past the limit here does not compile
# there, and one under it may still not.
LANE = 128  # the JAX kernels' lane padding of x, aux and the output
FWD_TILE, BWD_TILE = 512, 256
VMEM_LIMIT = 64 * 1024 * 1024


def jax_vmem(feat: int, esz: int, layers: int = 8) -> dict:
    """{kernel: bytes of its blocks (two buffers each) and scratch} at
    ``feat`` wide, one skip, heads feat / 2 (the JAX router's default,
    satnerf_tpu/models/field.py:117-119), element size ``esz``."""
    fl, f4 = feat // 2, 4

    def blocks(items):
        return 2 * sum(np.prod(s) * e for s, e in items)

    tw = [((LANE, feat), esz), ((layers - 1, feat, feat), esz), ((1, LANE, feat), esz),
          ((layers, feat), f4)]
    # the rs_semantic heads (FieldSpec.head_keys): hidden layers, projections
    # onto the 128 packed output lanes, biases
    hidden = [(feat, feat)] + [(feat, fl)] * 4 + [(LANE, fl)] * 4 + [(fl, fl)] * 2
    hw = ([(s, esz) for s in hidden + [(feat, LANE)] + [(fl, LANE)] * 5]
          + [((feat,), f4), ((7, fl), f4), ((LANE,), f4)])
    acts_b = (layers, BWD_TILE, feat)
    trunk_bwd = [((BWD_TILE, LANE), esz), *tw[:3], ((BWD_TILE, feat), esz),
                 ((BWD_TILE, LANE), esz), ((LANE, feat), f4), ((layers - 1, feat, feat), f4),
                 ((1, LANE, feat), f4), ((layers, feat), f4)]
    field_fwd = [((FWD_TILE, LANE), esz)] * 2 + tw + hw + [((FWD_TILE, LANE), f4)]
    heads_bwd = ([((BWD_TILE, feat), esz), ((BWD_TILE, LANE), esz), ((BWD_TILE, LANE), f4)]
                 + hw + [((BWD_TILE, feat), esz), ((BWD_TILE, LANE), esz)]
                 + [(s, f4) for s, _ in hw])
    return {"fused_trunk": blocks([((FWD_TILE, LANE), esz), *tw, ((FWD_TILE, feat), esz)]),
            "fused_field": blocks(field_fwd),
            "trunk_bwd_recompute": blocks(trunk_bwd + [((layers, feat), f4)])
            + 2 * np.prod(acts_b) * esz,
            "heads_bwd": blocks(heads_bwd)}


def test_jax_vmem_reckoning_puts_the_top_at_1024():
    """jax_vmem's count of the JAX kernels' VMEM blocks at 8 layers, heads
    feat / 2, against their 64 MiB limit: the trunk kernel's forward holds
    its blocks up to 1,024 in f32 (1,408 in bf16), the fused field up to 768
    (1,152), the trunk backward up to 640 (768); so 1,024 is the widest trunk
    the JAX package runs on its kernels in f32, and the port's widths stop
    there. Prints the MiB by width (``-rP`` shows them; PERF.md's table)."""
    def top(kernel, esz):
        return max(f for f in range(512, 1537, 128) if jax_vmem(f, esz)[kernel] <= VMEM_LIMIT)

    for feat in range(640, 1153, 128):
        print(feat, {k: [round(float(jax_vmem(feat, e)[k]) / 2**20, 1) for e in (4, 2)]
                     for k in jax_vmem(feat, 4)})
    assert (top("fused_trunk", 4), top("fused_trunk", 2)) == (1024, 1408)
    assert (top("fused_field", 4), top("fused_field", 2)) == (768, 1152)
    assert (top("trunk_bwd_recompute", 4), top("trunk_bwd_recompute", 2)) == (640, 768)
    assert max(trunk.FEAT_WIDTHS) == top("fused_trunk", 4)
