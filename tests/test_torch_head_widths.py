"""The port at every head width the JAX kernels take (t-embeddings up to 62
wide, 8 to 119 semantic classes), against the JAX package on the CPU.

- The field (``field_forward`` with ``trunk_impl="pallas"``) of rs_semantic
  at 128 x 128, which runs the fused field (K1, K2, K4; their plain versions
  here) as the JAX package runs its Pallas ``fused_field`` in interpret
  mode, at (tau, n_classes) (7, 8), (16, 12) and (62, 119), with
  ``use_tj_for_s`` on (at (62, 119) with the separate semantic t-embedding:
  the aux block's 128 columns all in use) and off. Three layers, a skip at 1,
  200 points, weights drawn from a numpy seed
  (``test_torch_widths.numpy_pair``). Bars (ROADMAP): outputs within 5e-5
  abs in f32; every parameter gradient and the t-embeddings' within 1e-4 of
  its tensor's largest element.
- K2's launch sequence (``_heads_backward_cuda``, its two kernels emulated:
  ``torch_parity.emulated_bwd_kernels``) at the same widths against the
  plain heads backward.
- K1's tensor-core dataflow (``test_torch_field_tc.emulate_field``) with
  its output 32 and 128 wide and its aux tile 32 and 128 wide, against the
  JAX fused field kernel in interpret mode at 8 x 512 (5e-5).
- The wrappers' limits are those of the CUDA sources, and past the JAX
  kernels' bounds both packages refuse the field.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_field_tc as field_tc
import test_torch_widths as widths
from satnerf_tpu.models import field as jfield
from satnerf_tpu.ops.pallas import field_fused as jff
from satnerf_torch.core.encoding import positional_encoding
from satnerf_torch.models import field as tfield
from satnerf_torch.models.import_params import field_state_from_params
from satnerf_torch.ops import _bwd, trunk
from satnerf_torch.ops import field_fused as tff
from torch_parity import emulated_bwd_kernels, field_inputs, max_err, one_thread

torch.set_num_threads(2)

# (tau, n_classes): the aux block 20, 36 and 128 wide (32, 48, 128 padded to
# 16), the output 32, 32 and 128 wide
CASES = [(7, 8), (16, 12), (62, 119)]
N_POINTS = 200
TOL_OUT = 5e-5
TOL_GRAD = 1e-4
N_EMULATED = 100  # the emulation's points: a whole 64-row tile and a ragged one


def _kw(tau: int, n_classes: int, tj_s: bool, sep: bool = False) -> dict:
    return dict(widths._kw(128, 128), t_embedding_tau=tau, n_classes=n_classes,
                use_tj_for_s=tj_s, use_separate_tj_for_semantic=sep)


def _ids(cases):
    return [f"tau{t}-c{c}-tjs{int(s)}-sep{int(p)}" for t, c, s, p in cases]


# use_tj_for_s on and off at each width; at (62, 119) on with the separate
# semantic t-embedding, the aux block's 128 columns all in use
FIELD_CASES = [(t, c, s, s and t == 62) for t, c in CASES for s in (True, False)]


@pytest.mark.parametrize("tau,n_classes,tj_s,sep", FIELD_CASES, ids=_ids(FIELD_CASES))
def test_field_at_head_width_matches_jax(tau, n_classes, tj_s, sep):
    """field_forward against the JAX package's on the same weights and
    N_POINTS seeded points: outputs within TOL_OUT, every parameter
    gradient and the t-embeddings' within TOL_GRAD of the JAX VJP's for one
    fixed cotangent per output."""
    kw = _kw(tau, n_classes, tj_s, sep)
    jcfg, params, tcfg, module = widths.numpy_pair(kw)
    assert tfield.use_fused_field(tcfg) and jfield._use_pallas_field(jcfg)
    spec = tfield.fused_field_spec(tcfg)
    assert spec.out_w == -(-(9 + n_classes) // 16) * 16 and spec.out_w > 16
    xyz, sun, _, te, ts = field_inputs(N_POINTS, tau=tau)
    g = np.random.default_rng(3)

    def jax_out(p, t, t_s):
        return jfield.field_forward(p, jcfg, jnp.asarray(xyz), sun_d=jnp.asarray(sun), t_emb=t,
                                    t_s_emb=t_s if sep else None)

    @jax.jit
    def out_and_vjp(p, t, t_s, w):  # one program: the outputs and the VJP of sum(out * w)
        out, vjp = jax.vjp(jax_out, p, t, t_s)
        return out, vjp(w)

    shapes = jax.eval_shape(jax_out, params, te, ts)
    assert shapes["semantic"].shape == (N_POINTS, n_classes)
    # a fixed cotangent per output: the gradients of sum(out * w)
    weights = {k: jnp.asarray(g.normal(size=v.shape).astype(np.float32))
               for k, v in shapes.items()}
    ref, (gp_j, gt_j, gts_j) = out_and_vjp(params, jnp.asarray(te), jnp.asarray(ts), weights)

    t_emb = torch.from_numpy(te).requires_grad_(True)
    t_s_emb = torch.from_numpy(ts).requires_grad_(True)
    before = tff.PLAIN_CALLS
    with one_thread():
        got = tfield.field_forward(module, tcfg, torch.from_numpy(xyz),
                                   sun_d=torch.from_numpy(sun), t_emb=t_emb,
                                   t_s_emb=t_s_emb if sep else None)
        sum(torch.sum(got[k] * torch.from_numpy(np.asarray(w)))
            for k, w in weights.items()).backward()
    assert tff.PLAIN_CALLS == before + 2  # K1's and K2's plain versions ran
    assert set(got) == set(ref)
    for k in ref:
        err = float((got[k].detach() - torch.from_numpy(np.asarray(ref[k]))).abs().max())
        assert err < TOL_OUT, (k, err)
    want = field_state_from_params(jax.tree.map(np.asarray, gp_j))
    grads = {k: p.grad for k, p in module.named_parameters()}
    assert set(grads) == set(want)
    for k in want:
        assert widths._rel(grads[k], want[k]) < TOL_GRAD, k
    assert widths._rel(t_emb.grad, gt_j) < TOL_GRAD, "t_emb"
    if sep:
        assert widths._rel(t_s_emb.grad, gts_j) < TOL_GRAD, "t_s_emb"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tau,n_classes", CASES)
def test_heads_backward_orchestration_at_head_width(tau, n_classes, dtype):
    """K2's launches at the new widths (g (n, out_w) as the reverse rows' A,
    the aux block padded to aux_pad, the g_aux launch 16 wide or padded to
    64-column tiles) with both kernels emulated, against the plain heads
    backward, and each launch's width one the CUDA row GEMM takes."""
    _, _, tcfg, module = widths.numpy_pair(_kw(tau, n_classes, True))
    spec = tfield.fused_field_spec(tcfg)
    n = 70
    xyz, sun, _, te, _ = (torch.from_numpy(a) for a in field_inputs(n, tau=tau))
    x = tff.pack_x(spec, positional_encoding(xyz, 10), dtype)
    aux = tff.pack_aux(spec, sun, te, None, dtype)
    packed = module.packed(dtype)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(n, spec.out_w))
                         .astype(np.float32))
    launched = []
    with torch.no_grad():
        _, shared, _ = tff._forward(spec, x, aux, packed, resid=True)
        ref = tff.heads_backward_reference(spec, shared, aux, g, packed)
        with emulated_bwd_kernels():
            row = _bwd.row_op

            def recording(*args, **kw):
                launched.append(kw["width"])
                return row(*args, **kw)

            _bwd.row_op = recording
            got = tff._heads_backward_cuda(spec, shared, aux, g, packed, True)
    assert all(w == _bwd.THIN_WIDTH or w % 64 == 0 for w in launched), launched
    assert tff.g_aux_width(spec) in launched
    assert got[1].shape == aux.shape
    for a, b in zip(got[:2], ref[:2]):
        assert widths._rel(a.float(), b.float()) < 1e-6
    assert set(got[2]) == set(ref[2]) == set(spec.head_keys())
    for k in ref[2]:
        assert got[2][k].shape == packed[k].shape
        assert widths._rel(got[2][k].float(), ref[2][k].float()) < 1e-6, k


@pytest.mark.parametrize("tau,n_classes", [(7, 8), (62, 119)])
def test_emulated_kernel_at_head_width_matches_jax_kernel(tau, n_classes):
    """K1's arithmetic (the emulation: every group of 16 output columns
    projected by its own m64n16 products, each warpgroup's half summed
    apart) with the output and the aux tile 32 wide, then 128 wide, against
    the JAX fused field kernel in interpret mode at 8 x 512 with 256-wide
    heads, f32, and against the port's plain version."""
    raw_j, out, (spec, x, aux, packed, *_) = field_tc._case(
        "f32", True, False, n=N_EMULATED, t_embedding_tau=tau, n_classes=n_classes)
    assert spec.out_w == spec.aux_pad == (32 if n_classes == 8 else 128)
    assert out.shape == (x.shape[0], spec.out_w)
    assert max_err(out, raw_j) < TOL_OUT
    ref = tff._reference_forward(spec, x, aux, packed, False)[0]
    assert max_err(out, ref.numpy()) < TOL_OUT
    # the prepared projections hold one (16, K) group after another
    prep = tff.tc_weights(packed)["w2_sem"]
    assert prep.shape[0] == spec.out_w // 16
    w = packed["w2_sem"]
    for grp in range(spec.out_w // 16):
        assert torch.equal(prep[grp], tff.tc_projection(w[:, 16 * grp:16 * (grp + 1)])[0])


def _csrc(name: str) -> str:
    with open(os.path.join(os.path.dirname(tff.__file__), os.pardir, "csrc", name)) as f:
        return f.read()


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_head_width_limits_match_the_cuda_sources():
    """K1's widest output and aux blocks (csrc/field_fused.cu kMaxOut,
    kMaxAux) are the wrapper's and the JAX kernels' 128; the plan of the
    widest field the port's routing sends to K1 (8 x 512, heads 512, 119
    classes) fits kMaxJobs (csrc/trunk_tc.cuh) with the room the bound in
    build_plan counts; the g_aux launch's rule matches csrc/bwd_common.cuh's
    thin width."""
    k1, tc, bwd = _csrc("field_fused.cu"), _csrc("trunk_tc.cuh"), _csrc("bwd_common.cuh")
    assert _constant(k1, "kMaxOut") == tff.MAX_OUT_W == 128
    assert _constant(k1, "kMaxAux") == tff.MAX_AUX_W == 128
    assert "(11 + sem_groups(a)) * passes(a.fl)" in k1
    passes = {128: 1, 256: 1, 384: 2, 512: 2}
    spec = tfield.fused_field_spec(tfield.FieldConfig(
        variant="rs_semantic", mapping=True, trunk_impl="pallas", fc_use_full_features=True,
        n_classes=119, t_embedding_tau=62))
    jobs = passes[spec.feat] * (spec.layers + 2) + (11 + spec.out_w // 16) * passes[spec.fl]
    assert jobs <= _constant(tc, "kMaxJobs")
    assert _constant(bwd, "kThinWidth") == _bwd.THIN_WIDTH == 16
    for tau in range(63):
        s = dataclasses.replace(spec, tau=tau)
        w = tff.g_aux_width(s)
        assert w == 16 if s.aux_pad == 16 else (w % 64 == 0 and 0 <= w - s.aux_pad < 64)


@pytest.mark.parametrize("tau,n_classes,ok", [(62, 119, True), (63, 5, False),
                                              (4, 120, False)])
def test_both_packages_bound_the_heads_alike(tau, n_classes, ok):
    """The port's FieldSpec takes what the JAX kernels' FieldSpec takes and
    raises (ValueError) where that one asserts."""
    kw = _kw(tau, n_classes, True)
    jcfg, tcfg = jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)
    tspec = jff.TrunkSpec(layers=3, feat=128, skips=(1,), c_in=jcfg.xyz_in)

    def jax_spec():
        return jff.FieldSpec(trunk=tspec, fl=128, tau=tau, n_classes=n_classes, has_beta=True,
                             has_semantic=True, use_tj_for_s=True, sep_t_s=False)

    if ok:
        jax_spec()
        spec = tfield.fused_field_spec(tcfg)
        assert (spec.out_w, spec.aux_pad) == (128, 128)
    else:
        with pytest.raises(AssertionError):
            jax_spec()
        with pytest.raises(ValueError):
            tfield.fused_field_spec(tcfg)
