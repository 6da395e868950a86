"""The port at every trunk width the JAX kernels take up to 512, against the
JAX package on the CPU.

- The field (``field_forward`` with ``trunk_impl="pallas"``) at each width
  pair of the routing table: (128, 128), (256, 128) and (384, 384) run the
  fused field (K1, K2, K4; their plain versions here), (128, 64) the trunk
  kernel with the heads layer by layer (K3, K4), as the JAX package runs
  its Pallas ``fused_field`` / ``fused_trunk`` in interpret mode. Three
  layers, a skip at 1, 200 points, weights drawn from a numpy seed and
  carried into both packages by ``models/import_params.py``. Bars (ROADMAP):
  every output within 5e-5 abs in f32; every parameter gradient and the
  t-embedding's within 1e-4 of its tensor's largest element.
- Both packages send each width pair to the same kernel, and the port's
  width lists hold what each route needs.
- The tensor-core forward's weight layout at widths that end with a
  128-column pass (128, 384): every element where csrc/trunk_tc.cuh reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params
from satnerf_torch.ops import _bwd, trunk
from satnerf_torch.ops import field_fused as tff
from torch_parity import field_inputs, one_thread

torch.set_num_threads(2)

# (feat, feat_last) pairs of the routing table; fl == feat: fc_use_full_features
PAIRS = [(128, 128), (256, 128), (384, 384), (128, 64)]
N_POINTS = 200
TOL_OUT = 5e-5  # f32 outputs, abs
TOL_GRAD = 1e-4  # gradients, relative to each tensor's largest element


def _kw(feat: int, fl: int) -> dict:
    return dict(variant="rs_semantic", layers=3, feat=feat, skips=(1,), mapping=True,
                trunk_impl="pallas", fc_use_full_features=fl == feat)


def numpy_pair(kw: dict, seed: int = 0):
    """(JAX config, JAX params, port config, port Field) with the same
    weights: each tensor drawn uniformly from a numpy generator within the
    range of its JAX initialisation, then carried to the port."""
    jcfg = jfield.FieldConfig(**kw)
    init = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.uniform(-1.0, 1.0, a.shape) * np.abs(a).max()).astype(np.float32), init)
    tcfg = tfield.FieldConfig(**kw)
    module = tfield.Field(tcfg)
    module.load_state_dict(field_state_from_params(params))
    return jcfg, params, tcfg, module


def _rel(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("feat,fl", PAIRS, ids=[f"{a}x{b}" for a, b in PAIRS])
def test_field_at_width_matches_jax(feat, fl):
    tcfg = field_matches_jax(_kw(feat, fl))
    assert tcfg.feat_last == fl


def field_matches_jax(kw: dict):
    """The port's field_forward against the JAX package's on the same
    weights (numpy_pair) and N_POINTS seeded points: outputs within TOL_OUT,
    every parameter gradient and the t-embedding's within TOL_GRAD of the
    JAX VJP's for one fixed cotangent per output. -> the port's config."""
    jcfg, params, tcfg, module = numpy_pair(kw)
    assert tcfg.feat_last == jcfg.feat_last and tcfg.xyz_in == jcfg.xyz_in
    xyz, sun, _, te, _ = field_inputs(N_POINTS)
    g = np.random.default_rng(3)

    def jax_out(p, t):
        return jfield.field_forward(p, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun), t_emb=t)

    ref, vjp = jax.vjp(jax.jit(jax_out), params, jnp.asarray(te))
    # a fixed cotangent per output: the gradients of sum(out * w)
    weights = {k: jnp.asarray(g.normal(size=v.shape).astype(np.float32))
               for k, v in ref.items()}
    gp_j, gt_j = vjp(weights)

    t_emb = torch.from_numpy(te).requires_grad_(True)
    with one_thread():
        got = tfield.field_forward(module, tcfg, torch.from_numpy(xyz),
                                   sun_d=torch.from_numpy(sun), t_emb=t_emb)
        sum(torch.sum(got[k] * torch.from_numpy(np.asarray(w)))
            for k, w in weights.items()).backward()
    assert set(got) == set(ref)
    for k in ref:
        err = float((got[k].detach() - torch.from_numpy(np.asarray(ref[k]))).abs().max())
        assert err < TOL_OUT, (k, err)
    want = field_state_from_params(jax.tree.map(np.asarray, gp_j))
    grads = {k: p.grad for k, p in module.named_parameters()}
    assert set(grads) == set(want)
    for k in want:
        assert _rel(grads[k], want[k]) < TOL_GRAD, k
    assert _rel(t_emb.grad, gt_j) < TOL_GRAD, "t_emb"
    return tcfg


@pytest.mark.parametrize("feat,fl", PAIRS + [(384, 192), (512, 256), (512, 512)])
def test_both_packages_route_each_width_alike(feat, fl):
    """The port's use_fused_field / use_fused_trunk are the JAX package's
    _use_pallas_field / _use_pallas_trunk at each pair, and the route's
    kernels take the pair: K1 and K2 (KERNEL_WIDTHS, HEADS_BWD_FL), K3 and
    K4 (FEAT_WIDTHS)."""
    kw = _kw(feat, fl)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    assert tcfg.feat_last == fl
    fused = jfield._use_pallas_field(jcfg)
    assert tfield.use_fused_field(tcfg) == fused
    assert tfield.use_fused_trunk(tcfg) == (jfield._use_pallas_trunk(jcfg) and not fused)
    assert feat in trunk.FEAT_WIDTHS
    if fused:
        assert (feat, fl) in tff.KERNEL_WIDTHS and fl in tff.HEADS_BWD_FL
    else:
        assert fl % 128 != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat,fl", [(128, 128), (384, 384), (256, 128)])
def test_tail_pass_layout_is_where_the_kernel_reads(dtype, feat, fl):
    """tc_weights at widths with a 128-column pass: W^T (N, K) of each
    weight lies pass after pass, pass p (256 rows, or the last 128) from
    row 256 p on, k-step s of it a (rows, 32-byte) tile with each row's
    16-byte halves swapped where (row / 4) is odd; the 16-row projections
    (K permuted by PROJ_PERM in f32) k-step after k-step."""
    _, _, tcfg, module = numpy_pair(_kw(feat, fl))
    with torch.no_grad():
        packed = module.packed(dtype)
        prep = tff.tc_weights(packed)
    ks = 32 // torch.tensor([], dtype=dtype).element_size()
    rng = np.random.default_rng(5)
    checked = 0
    for k, w in packed.items():
        if k.startswith("b"):
            assert prep[k] is w
            continue
        wt = w.transpose(-1, -2)
        if k.startswith("w2_") and dtype == torch.float32:
            perm = torch.tensor(tff.PROJ_PERM)
            wt = wt[..., (torch.arange(wt.shape[-1]).view(-1, 8)[:, perm]).reshape(-1)]
        n, kp = wt.shape[-2], _bwd.padded_k(wt.shape[-1])
        full = _bwd.pad_cols(wt, kp).reshape(-1, n, kp)
        flat = prep[k].reshape(full.shape[0], -1)
        assert flat.shape[1] == n * kp and prep[k].dtype == dtype, k
        for r_, c in zip(rng.integers(0, n, 64), rng.integers(0, kp, 64)):
            r_, c = int(r_), int(c)
            if k.startswith("w2_"):
                p, rows, r = 0, 16, r_
            else:
                p = r_ // trunk.TC_PASS_ROWS
                whole = (p + 1) * trunk.TC_PASS_ROWS <= n
                rows, r = (trunk.TC_PASS_ROWS if whole else trunk.TC_TAIL_ROWS), r_ % 256
            s, e = divmod(c, ks)
            half, e2 = divmod(e, ks // 2)
            at = (p * trunk.TC_PASS_ROWS * kp + (s * rows + r) * ks
                  + (half ^ ((r >> 2) & 1)) * (ks // 2) + e2)
            assert torch.equal(flat[:, at], full[:, r_, c]), k
            checked += 1
    assert checked > 0


def test_tail_layout_refuses_widths_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="passes"):
        trunk.tc_operand(torch.zeros(320, 64))
