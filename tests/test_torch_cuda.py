"""Each CUDA kernel of satnerf_torch (K1 with its residuals, K2, K3 and its
interleaved variant K6, K4, K5 and its backward) against its plain PyTorch
version, on the card, one tensor-core layer of the forward against the
3xTF32 emulation of ops/_bwd.py, the training loop on the card (its
launches, and a bitwise resume), and the eval battery and an HTTP render of
a trained run (their launches, and agreement with the CPU). Marked
``cuda``: without a GPU every test here skips.

The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q
"""

import dataclasses
import json

import pytest
import torch

from satnerf_torch.ops.field_fused import KERNEL_WIDTHS as K1_WIDTHS  # K1's (feat, feat_last)
from satnerf_torch.ops.trunk import FEAT_WIDTHS as TRUNK_WIDTHS  # K3's and K4's feat


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from satnerf_torch.device import disable_tf32

    disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads_on", [True, False])
@pytest.mark.parametrize("feat,fl", K1_WIDTHS)
def test_cuda_field_kernel_matches_plain(cuda_device, dtype, heads_on, feat, fl,
                                         record_property):
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff

    # every width pair K1 takes: heads of half the trunk's width or, with
    # full features, all of it
    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=feat, skips=(2,),
                      mapping=True, use_tj_for_s=True, trunk_impl="pallas",
                      fc_use_full_features=fl == feat)
    assert cfg.feat_last == fl
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    spec = dataclasses.replace(fused_field_spec(cfg), heads_on=heads_on)
    g = torch.Generator().manual_seed(1)
    n = 1001
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10).to(cuda_device)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(cuda_device)
    te = torch.randn(n, 4, generator=g).to(cuda_device)
    with torch.no_grad():
        packed = field.packed(dtype)
        x = ff.pack_x(spec, enc, dtype)
        aux = ff.pack_aux(spec, sun, te, None, dtype)
        before = ff.LAUNCHES
        got = ff.fused_field(spec, x, aux, packed)
        torch.cuda.synchronize()
        assert ff.LAUNCHES == before + 1
        ref = ff.fused_field_reference(spec, x, aux, packed)
    # bf16: the same arithmetic on both sides; chip_smoke.py TOL_FIELD says why 2e-2
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    err = float((got - ref).abs().max())
    record_property("max_abs_err", err)  # read with --junitxml
    assert err < tol


# with rays past the forward's 256-sample segment, so its carries run on the card
COMPOSITE_SHAPES = [(1, 1), (1001, 64), (77, 37), (1024, 192), (33, 33), (129, 300),
                    (64, 1024)]


def _composite_inputs(cuda_device, b, s, seed):
    """Seeded inputs with sun and sky as the renderer passes them: row views
    of (B, S + 3) and (B, S, 3) tensors (row strides S + 3 and 3S)."""
    g = torch.Generator().manual_seed(seed)
    sig = torch.rand(b, s, generator=g) * 6 - 1
    sig[:4] = -torch.rand(min(b, 4), s, generator=g)  # rays with no density
    z = torch.sort(torch.rand(b, s, generator=g) * 2, dim=1).values
    alb = torch.rand(b, s, 3, generator=g)
    sun = torch.rand(b, s + 3, generator=g)
    sky = torch.rand(b, 1, 3, generator=g).expand(b, s, 3).contiguous()
    sig, z, alb, sun, sky = (t.to(cuda_device) for t in (sig, z, alb, sun, sky))
    return [sig, z, alb, sun[:, :s], sky[:, 0, :]]  # views made on the card


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", COMPOSITE_SHAPES)
def test_cuda_composite_kernel_matches_plain(cuda_device, b, s):
    """K5 on strided sun/sky rows against its plain version; two runs, and a
    run on contiguous copies, bit for bit equal."""
    from satnerf_torch.ops import composite as comp

    args = _composite_inputs(cuda_device, b, s, b)
    if b > 1 and s > 1:
        assert not args[3].is_contiguous() and not args[4].is_contiguous()
    before = comp.LAUNCHES
    got = comp.composite(*args)
    torch.cuda.synchronize()
    assert comp.LAUNCHES == before + 1
    again = comp.composite(*args)
    flat = comp.composite(*(t.contiguous() for t in args))
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert all(torch.equal(a, c) for a, c in zip(got, flat))
    ref = comp.composite_reference(*args)
    for name, a, r, tol in zip(("w", "t", "depth", "rgb"), got, ref,
                               (1e-6, 1e-6, 1e-5, 1e-5)):
        assert a.shape == r.shape, name
        assert float((a - r).abs().max()) <= tol, name


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads_on", [True, False])
@pytest.mark.parametrize("bwd", ["recompute", "stored"])
@pytest.mark.parametrize("feat,fl", K1_WIDTHS)
def test_cuda_backward_kernels_match_plain(cuda_device, dtype, heads_on, bwd, feat, fl,
                                           record_property):
    """K1's residuals, K2 and K4 against their plain versions at 4 layers of
    every width pair K1 takes on 1,001 points, and two runs bit for bit equal
    (no atomics)."""
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=feat, skips=(2,),
                      mapping=True, use_tj_for_s=True, trunk_impl="pallas",
                      trunk_bwd=bwd, fc_use_full_features=fl == feat)
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    spec = dataclasses.replace(fused_field_spec(cfg), heads_on=heads_on)
    g = torch.Generator().manual_seed(2)
    n = 1001
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10).to(cuda_device)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(cuda_device)
    te = torch.randn(n, 4, generator=g).to(cuda_device)
    g_out = torch.randn(n, 16, generator=g).to(cuda_device)
    with torch.no_grad():
        packed = field.packed(dtype)
        x = ff.pack_x(spec, enc, dtype)
        aux = ff.pack_aux(spec, sun, te, None, dtype)
        _, shared, acts = ff._forward(spec, x, aux, packed, resid=True)
        runs = []
        for _ in range(2):
            before = (ff.HEADS_BWD_LAUNCHES, trunk.LAUNCHES)
            h = ff.heads_backward(spec, shared, aux, g_out, packed)
            t = trunk.trunk_backward(spec, x, packed, acts, h[0])
            torch.cuda.synchronize()
            assert (ff.HEADS_BWD_LAUNCHES, trunk.LAUNCHES) == (before[0] + 1, before[1] + 1)
            runs.append([h[0], h[1], *h[2].values(), *t])
        ref_h = ff.heads_backward_reference(spec, shared, aux, g_out, packed)
        ref_t = trunk.trunk_backward_reference(spec, x, packed, acts, ref_h[0])
    ref = [ref_h[0], ref_h[1], *ref_h[2].values(), *ref_t]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    worst = max(_rel(a, b) for a, b in zip(runs[0], ref))
    record_property("max_rel_err", worst)
    # bf16: as for K1 (chip_smoke.py TOL_FIELD), one-ulp flips of an activation
    assert worst < (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", COMPOSITE_SHAPES)
def test_cuda_composite_backward_matches_plain(cuda_device, b, s):
    """K5's backward on strided sun/sky rows against autograd through the
    plain version; two runs, and a run on contiguous copies, bit for bit
    equal; rays with no density pass no gradient to sigma."""
    from satnerf_torch.ops import composite as comp

    ins = _composite_inputs(cuda_device, b, s, b + 1)
    g = torch.Generator().manual_seed(b + 2)
    cots = [torch.randn(b, s, generator=g), torch.randn(b, s, generator=g),
            torch.randn(b, generator=g), torch.randn(b, 3, generator=g)]
    cots = [t.to(cuda_device) for t in cots]

    def grads(fn, strided=True):
        leaves = [t.clone().requires_grad_(i != 1) for i, t in enumerate(ins)]
        args = list(leaves)
        if strided:  # the same values through row views of wider tensors
            args[3] = torch.nn.functional.pad(leaves[3], (0, 3))[:, :s]
            args[4] = leaves[4][:, None, :].expand(b, s, 3).contiguous()[:, 0, :]
        torch.autograd.backward(fn(*args), cots)
        return [leaves[i].grad for i in (0, 2, 3, 4)]

    before = comp.BWD_LAUNCHES
    got = grads(comp.composite)
    torch.cuda.synchronize()
    assert comp.BWD_LAUNCHES == before + 1
    again = grads(comp.composite)
    flat = grads(comp.composite, strided=False)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert all(torch.equal(a, c) for a, c in zip(got, flat))
    ref = grads(comp.composite_reference)
    for name, a, r, tol in zip(("sigmas", "albedo", "sun", "sky"), got, ref,
                               (1e-6, 1e-5, 1e-6, 1e-6)):
        assert float((a - r).abs().max()) <= tol, name
    assert torch.all(got[0][:4] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("made_in_inference", [True, False])
def test_cuda_prepared_weights_follow_an_in_place_change(cuda_device, made_in_inference):
    """K1 and K3 again on packed weights changed in place inside
    ``torch.inference_mode`` run the new weights: an inference tensor keeps
    no version, so its tensor-core preparation is never reused."""
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,), mapping=True,
                      use_tj_for_s=True, trunk_impl="pallas")
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    spec = fused_field_spec(cfg)
    g = torch.Generator().manual_seed(3)
    n, f32 = 257, torch.float32
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10).to(cuda_device)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(cuda_device)
    te = torch.randn(n, 4, generator=g).to(cuda_device)
    x, aux = ff.pack_x(spec, enc, f32), ff.pack_aux(spec, sun, te, None, f32)
    with torch.no_grad():
        packed = {k: v.clone() for k, v in field.packed(f32).items()}
    with torch.inference_mode():
        if made_in_inference:
            packed = {k: v.clone() for k, v in packed.items()}
        first = ff.fused_field(spec, x, aux, packed), trunk.fused_trunk(spec, x, packed)
        for k in ("w0", "w_mid", "b", "w2_rgb"):
            packed[k].mul_(0.5)  # in place: same storage
        out, h = ff.fused_field(spec, x, aux, packed), trunk.fused_trunk(spec, x, packed)
        torch.cuda.synchronize()
        ref = ff.fused_field_reference(spec, x, aux, packed)
        ref_h = trunk.fused_trunk_reference(spec, x, packed)[0]
    assert not torch.equal(out, first[0]) and not torch.equal(h, first[1])
    assert float((out - ref).abs().max()) < 5e-5
    assert float((h - ref_h).abs().max()) < 5e-5


@pytest.mark.cuda
def test_cuda_hierarchical_render_prepares_each_field_once(cuda_device):
    """A hierarchical render (coarse and fine K1 fields) prepares each field's
    tensor-core weights once: served twice from Field.packed, and trained
    (forward and backward with remat) inside one shared_packing block."""
    import os

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models.field import shared_packing
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk
    from satnerf_torch.render.renderer import render_rays
    from satnerf_torch.train.state import init_params

    toml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "pipelines", "rs_semantic.toml")
    rcfg = load_render_config(toml, device=cuda_device, trunk_impl="pallas",
                              n_importance=128, use_fine_network=True, remat_chunks=2,
                              sc_stride=2)
    params = init_params(torch.Generator().manual_seed(0), rcfg.field, t_vocab=8,
                         device=cuda_device, use_fine_network=True)
    g = torch.Generator().manual_seed(4)
    n = 256
    o = torch.cat([torch.rand(n, 2, generator=g) * 1.6 - 0.8, torch.ones(n, 1)], 1)
    d = torch.nn.functional.normalize(
        torch.cat([torch.rand(n, 2, generator=g) * 0.3 - 0.15, -torch.ones(n, 1)], 1), dim=1)
    rays = torch.cat([o, d, torch.zeros(n, 1), torch.full((n, 1), 2.0)], 1).to(cuda_device)
    sun = torch.nn.functional.normalize(torch.tensor([0.2, -0.1, 0.8]), dim=0)
    extras = torch.cat([sun.expand(n, 3), torch.full((n, 1), 3.0)], 1).to(cuda_device)
    serve_cfg = dataclasses.replace(rcfg, solar_correction=False)  # as RenderService
    with torch.inference_mode():
        preps, launches = trunk.TC_PREPARATIONS, ff.LAUNCHES
        render_rays(params, serve_cfg, rays, extras)
        assert trunk.TC_PREPARATIONS - preps == 2 and ff.LAUNCHES - launches == 2
        render_rays(params, serve_cfg, rays, extras)
        assert trunk.TC_PREPARATIONS - preps == 2 and ff.LAUNCHES - launches == 4
    preps, launches = trunk.TC_PREPARATIONS, ff.LAUNCHES
    with shared_packing():
        out = render_rays(params, rcfg, rays, extras,
                          generator=torch.Generator(device=cuda_device).manual_seed(0))
        (out["rgb"].sum() + out["depth"].sum()).backward()
    torch.cuda.synchronize()
    assert ff.LAUNCHES - launches > 4  # every remat tile, forward and recomputed
    assert trunk.TC_PREPARATIONS - preps == 2


def _trunk_case(cuda_device, n=1001, feat=512, **cfg_kw):
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=feat, skips=(2,), mapping=True,
                      trunk_impl="pallas", use_separate_beta_for_s=True, **cfg_kw)
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator().manual_seed(4)
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10).to(cuda_device)
    return cfg, field, fused_field_spec(cfg), enc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emit_acts", [False, True])
@pytest.mark.parametrize("feat", TRUNK_WIDTHS)
def test_cuda_trunk_kernel_matches_plain(cuda_device, dtype, emit_acts, feat, record_property):
    """K3 against its plain version at every trunk width it takes on 1,001
    points (ragged against the 64-row tile), bitwise repeatable; at 512, K6
    (the warp-specialised ping-pong loop of csrc/trunk_ws.cuh, which keeps
    K3's order of sums and its epilogue) bitwise equal to K3 and so within
    the same bar of the plain version."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    _, field, spec, enc = _trunk_case(cuda_device, feat=feat)
    with_il = feat in trunk.IL_FEAT_WIDTHS
    with torch.no_grad():
        packed = field.packed(dtype)
        x = ff.pack_x(spec, enc, dtype)
        before = (trunk.FWD_LAUNCHES, trunk.INTERLEAVED_LAUNCHES)
        out, acts = trunk._forward(spec, x, packed, emit_acts)
        again, acts2 = trunk._forward(spec, x, packed, emit_acts)
        if with_il:
            il = trunk.fused_trunk_interleaved(spec, x, packed)
            il2 = trunk.fused_trunk_interleaved(spec, x, packed)
        torch.cuda.synchronize()
        assert (trunk.FWD_LAUNCHES, trunk.INTERLEAVED_LAUNCHES) == (
            before[0] + 2, before[1] + (2 if with_il else 0))
        ref, ref_acts = trunk.fused_trunk_reference(spec, x, packed, emit_acts)
    assert out.dtype == dtype and out.shape == (x.shape[0], feat)
    # each bitwise repeatable; K6 bitwise K3 (whose output does not depend
    # on emit_acts)
    assert torch.equal(out, again)
    if with_il:
        assert torch.equal(il, il2) and torch.equal(il, out)
    # chip_smoke.py TOL_FIELD / TOL_RESID say why bf16 has its own bar
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    err = float((out.float() - ref.float()).abs().max())
    record_property("max_abs_err", err)
    assert err < tol
    if with_il:
        assert float((il.float() - ref.float()).abs().max()) < tol
    if emit_acts:
        assert acts.shape == (spec.layers, x.shape[0], feat) and torch.equal(acts, acts2)
        assert _rel(acts, ref_acts) < (5e-5 if dtype == torch.float32 else 4e-2)
    else:
        assert acts is None


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 65, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_interleaved_trunk_ragged(cuda_device, n, dtype):
    """K6 at ragged n (one row, one past the 64-row tile, 300): one launch
    per call, bitwise equal to K3 and to itself, within the field bar of the
    plain version, on weights whose preparation is cached."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    _, field, spec, enc = _trunk_case(cuda_device, n=n)
    with torch.no_grad():
        packed = field.packed(dtype)
        x = ff.pack_x(spec, enc, dtype)
        before = trunk.INTERLEAVED_LAUNCHES
        il = trunk.fused_trunk_interleaved(spec, x, packed)
        il2 = trunk.fused_trunk_interleaved(spec, x, packed)
        k3 = trunk.fused_trunk(spec, x, packed)
        torch.cuda.synchronize()
        assert trunk.INTERLEAVED_LAUNCHES == before + 2
        ref = trunk.fused_trunk_reference(spec, x, packed)[0]
    assert il.shape == (n, 512) and il.dtype == dtype
    assert torch.equal(il, il2) and torch.equal(il, k3)
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    assert float((il.float() - ref.float()).abs().max()) < tol
    assert f"trunk_split/{dtype}" in packed.prepared


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["recompute", "stored"])
@pytest.mark.parametrize("feat", TRUNK_WIDTHS)
def test_cuda_fused_trunk_backward_matches_plain(cuda_device, bwd, feat):
    """FusedTrunk (K3 forward, K4 backward) against the plain forward and
    backward on the same inputs, f32, at every trunk width they take."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    _, field, spec, enc = _trunk_case(cuda_device, feat=feat, trunk_bwd=bwd)
    packed = {k: v.clone().requires_grad_(True) for k, v in field.packed(torch.float32).items()}
    x = ff.pack_x(spec, enc, torch.float32).requires_grad_(True)
    cot = torch.randn(x.shape[0], feat, generator=torch.Generator().manual_seed(5))
    cot = cot.to(cuda_device)
    before = (trunk.FWD_LAUNCHES, trunk.LAUNCHES)
    grads = torch.autograd.grad(trunk.fused_trunk(spec, x, packed),
                                [x] + [packed[k] for k in trunk.TRUNK_KEYS], cot)
    torch.cuda.synchronize()
    assert (trunk.FWD_LAUNCHES, trunk.LAUNCHES) == (before[0] + 1, before[1] + 1)
    plain = {k: v.detach() for k, v in packed.items()}
    _, acts = trunk.fused_trunk_reference(spec, x.detach(), plain, emit_acts=True)
    ref = trunk.trunk_backward_reference(spec, x.detach(), plain,
                                         acts if bwd == "stored" else None, cot)
    assert max(_rel(a, b) for a, b in zip(grads, ref)) < 1e-4


@pytest.mark.cuda
def test_cuda_tj_instead_of_beta_field_runs_k3(cuda_device):
    """The use_tj_instead_of_beta field through K3 on the card against the
    same field's plain path on the CPU (5e-5, the field bar)."""
    from satnerf_torch.models.field import Field, field_forward
    from satnerf_torch.ops import trunk

    cfg, field, spec, _ = _trunk_case(cuda_device, use_tj_instead_of_beta=True)
    g = torch.Generator().manual_seed(6)
    xyz = torch.rand(777, 3, generator=g) * 2 - 1
    sun = torch.nn.functional.normalize(torch.randn(777, 3, generator=g), dim=1)
    te = torch.randn(777, 4, generator=g)
    cpu_field = Field(cfg)
    cpu_field.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    before = trunk.FWD_LAUNCHES
    with torch.no_grad():
        got = field_forward(field, cfg, xyz.to(cuda_device), sun_d=sun.to(cuda_device),
                            t_emb=te.to(cuda_device), n_full=500)
        torch.cuda.synchronize()
        ref = field_forward(cpu_field, cfg, xyz, sun_d=sun, t_emb=te, n_full=500)
    assert trunk.FWD_LAUNCHES == before + 1
    assert set(got) == set(ref)
    for k in ref:
        assert float((got[k].cpu() - ref[k]).abs().max()) < 5e-5, k


# -- the two building blocks of K2 and K4 (csrc/bwd_common.cuh) at ragged sizes -----

ROWS_RAGGED = 65_537  # one past a multiple of the 128-row tile and the 8,192-row chunk
# 3xTF32 (f32) and bf16 operands both sum in f32 on the tensor cores: the
# blocks agree with an f64 product of the same operands to the f32 rounding of
# K-term sums, ~1e-6 of the largest output; 1e-5 is the bar
TOL_BLOCK = 1e-5


def _block_inputs(dev, dtype, shapes, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g).to(dev).to(dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,width", [(16, 512), (60, 256), (512, 512), (512, 16), (60, 64),
                                     (16, 128), (60, 384), (1024, 768), (1024, 1024),
                                     (512, 192)])
def test_cuda_row_gemm_block_matches_torch(cuda_device, dtype, k, width, record_property):
    """row_op: A (65,537, K) @ W (K, width) + an f32 addend + bias, both
    epilogue outputs, against torch in f64; two runs bit for bit equal."""
    from satnerf_torch.ops import _bwd
    from satnerf_torch.ops.fastmath import SIN_MODES, SINE_ENGINES

    n = ROWS_RAGGED
    a, wt = _block_inputs(cuda_device, dtype, [(n, k), (width, k)], k + width)
    add, bias = _block_inputs(cuda_device, torch.float32, [(n, width), (width,)], 7)
    runs = []
    for _ in range(2):
        main = torch.empty((n, width), dtype=torch.float32, device=cuda_device)
        second = torch.empty((n, width), dtype=dtype, device=cuda_device)
        _bwd.row_op("trunk_bwd" if width != 16 else "field_bwd",
                    "trunk_bwd_row" if width != 16 else "heads_bwd_row", dtype, n, width,
                    prods=[(a, wt)], add=add, bias=bias, mode=_bwd.FWD_SINE,
                    out_f32=main, out2_dt=second)
        torch.cuda.synchronize()
        runs.append((main, second))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    ref = (a.double() @ wt.double().t() + add.double() + bias.double()).float()
    err = _rel(runs[0][0], ref)
    record_property("max_rel_err", err)
    assert err < TOL_BLOCK
    # the sine epilogue of the same sums: the engines' bar (chip_smoke.py
    # TOL_SINE) in f32, one bf16 ulp below 1 in bf16
    sine = SINE_ENGINES[SIN_MODES[0]]
    sin_err = float((runs[0][1].float() - sine(runs[0][0]).to(dtype).float()).abs().max())
    assert sin_err <= (1e-6 if dtype == torch.float32 else 2 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,k", [(64, 16), (128, 60), (192, 72), (512, 512), (768, 1024),
                                     (1024, 40)])
def test_cuda_row_weight_kernel_matches_torch(cuda_device, dtype, width, k):
    """The row GEMM's weight tiles (ops/_bwd.py:row_weight) from the card's
    prep_kernel bit for bit those of its torch construction on the CPU, on
    a W^T view whose rows are k + 5 apart."""
    from satnerf_torch.ops import _bwd

    g = torch.Generator().manual_seed(width + k)
    full = torch.randn(width, k + 5, generator=g).to(dtype)
    got = _bwd.row_weight(full.to(cuda_device)[:, :k], dtype)
    ref = _bwd.row_weight(full[:, :k], dtype)
    torch.cuda.synchronize()
    assert got.bn == ref.bn and torch.equal(got.tiles.cpu(), ref.tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,m", [(16, 256), (60, 512), (512, 512), (512, 16), (1024, 64),
                                 (128, 1024), (384, 768), (60, 128)])
def test_cuda_reduce_block_matches_torch(cuda_device, dtype, k, m, record_property):
    """reduce_op: dW = A^T B over 65,537 rows (9 chunks) and the column sums
    of B (folded into the GEMM in f32, a separate job in bf16) against torch
    in f64; two runs bit for bit equal."""
    from satnerf_torch.ops import _bwd

    n = ROWS_RAGGED
    a, b = _block_inputs(cuda_device, dtype, [(n, k), (n, m)], k * m)
    runs = []
    for _ in range(2):
        out = torch.empty((k, m), dtype=torch.float32, device=cuda_device)
        db = torch.empty((m,), dtype=torch.float32, device=cuda_device)
        _bwd.reduce_op("trunk_bwd", "trunk_bwd_reduce", dtype, n, gemms=[(a, b, out)],
                       sums=[(b, db)])
        torch.cuda.synchronize()
        runs.append((out, db))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    err = _rel(runs[0][0], a.double().t() @ b.double())
    db_err = _rel(runs[0][1], b.double().sum(0))
    record_property("max_rel_err", max(err, db_err))
    assert err < TOL_BLOCK and db_err < TOL_BLOCK


# The f32 sums of K2 and K4 where their terms cancel, as a head's bias
# gradient does at trained weights (chip_smoke.py trained_audit; k2_audit.py
# located the excess in the row GEMM and in the reduction's bias sums). The
# tensor cores add into their accumulator with truncation toward zero, so an
# error leans the way the running sum points; where the sum then cancels, the
# leanings stay. Each stage alone, its f32 operands seeded so that every
# column's sum comes to 1e-2 or less of the sum of its terms' sizes (held
# below), against f64: the kernel's error, over the largest column sum, at
# most CANCEL_RATIO times that of torch's f32 product or sum of the same
# operands (TF32 off). The operands are values that 3xTF32 holds exactly
# (hi + lo of ops/_bwd.py:split_tf32), so that the test holds the sums: the
# split keeps 22 of a weight's 24 bits, and rows of one sign summed against a
# weight whose partner in the cancellation differs (a row GEMM's products
# taking each other back but for 1e-3) carry that rounding of the weight
# coherently (25x torch's error on raw f32 operands on an H100, PERF.md).
N_CANCEL = 65_536
EPS_CANCEL = 1e-3
CANCEL_RATIO = 2.0


def _paired_rows(dev, g, *blocks):
    """(block, factor) pairs -> each block stacked on factor * block in
    another row order, the 2 x rows shuffled by one permutation, f32."""
    half = blocks[0][0].shape[0]
    mix, perm = torch.randperm(half, generator=g), torch.randperm(2 * half, generator=g)
    return [torch.cat([b, f * b[mix]])[perm].contiguous().to(dev) for b, f in blocks]


def _split_exact(x):
    """x rounded to a value 3xTF32 holds exactly: hi + lo of its split."""
    from satnerf_torch.ops import _bwd

    return sum(_bwd.split_tf32(x))


def _cancel_err(got, truth) -> float:
    """max |got - truth| over max |truth|, in f64."""
    return float((got.double() - truth).abs().max() / truth.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["row_gemm", "reduction"])
def test_cuda_f32_backward_sums_hold_f64_where_terms_cancel(cuda_device, stage,
                                                            record_property):
    """``row_gemm``: the row GEMM at K 1,024, four products of K 256 as K2's
    g_feats launch has them, where products 1 and 3 take back all but
    about EPS_CANCEL of products 0 and 2 (positive A, so each running sum
    first grows); each output column summed over N_CANCEL rows in f64.
    One accumulator over all of K (each k-step's three passes in turn) read
    2.5e-3 here against torch's 1.7e-6, on raw operands on an H100.
    ``reduction``: dW = A^T B and the bias sum of B (folded into the GEMM's
    pass, as f32 has it) over N_CANCEL rows, half of them the other half's
    times -(1 - EPS_CANCEL), shuffled."""
    from satnerf_torch.ops import _bwd

    g = torch.Generator().manual_seed(11)
    n, k, width = N_CANCEL, 256, 256
    if stage == "row_gemm":
        a0, a2 = torch.rand(n, k, generator=g), torch.rand(n, k, generator=g)
        w0, w2 = (torch.randn(width, k, generator=g) / 16 for _ in range(2))
        a = [a0, (1.0 - EPS_CANCEL) * a0, a2, (1.0 - EPS_CANCEL) * a2]
        w = [w0, -w0, w2, EPS_CANCEL * torch.randn(width, k, generator=g) / 16 - w2]
        a = [_split_exact(x).to(cuda_device) for x in a]
        w = [_split_exact(x).to(cuda_device) for x in w]
        got = torch.empty((n, width), dtype=torch.float32, device=cuda_device)
        _bwd.row_op("field_bwd", "heads_bwd_row", torch.float32, n, width,
                    prods=list(zip(a, w)), mode=_bwd.PLAIN, out_f32=got)
        lib = torch.cat(a, dim=1) @ torch.cat(w, dim=1).t()
        truth = torch.cat(a, dim=1).double() @ torch.cat(w, dim=1).double().t()
        terms = torch.cat(a, dim=1).double().abs() @ torch.cat(w, dim=1).double().abs().t()
        sums, terms = truth.sum(0), terms.sum(0)
        errs = {"row_gemm": (_cancel_err(got.double().sum(0), sums),
                             _cancel_err(lib.double().sum(0), sums))}
    else:
        a, b = _paired_rows(cuda_device, g, (torch.rand(n // 2, 64, generator=g), 1.0),
                            (torch.rand(n // 2, width, generator=g), -(1.0 - EPS_CANCEL)))
        a, b = _split_exact(a), _split_exact(b)
        gw = torch.empty((64, width), dtype=torch.float32, device=cuda_device)
        gb = torch.empty((width,), dtype=torch.float32, device=cuda_device)
        _bwd.reduce_op("field_bwd", "heads_bwd_reduce", torch.float32, n,
                       gemms=[(a, b, gw)], sums=[(b, gb)])
        tw, sums = a.double().t() @ b.double(), b.double().sum(0)
        terms = b.double().abs().sum(0)
        errs = {"dW": (_cancel_err(gw, tw), _cancel_err(a.t() @ b, tw)),
                "bias": (_cancel_err(gb, sums), _cancel_err(b.sum(0), sums))}
    torch.cuda.synchronize()
    assert float((sums.abs() / terms).max()) <= 1e-2  # the terms cancel
    record_property("errors", errs)
    for name, (kernel, plain) in errs.items():
        assert kernel <= CANCEL_RATIO * plain, (name, kernel, plain)


# -- the tensor-core forward (csrc/trunk_tc.cuh) -------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_layer_is_3xtf32(cuda_device, dtype, record_property):
    """Two trunk layers through K3 with their pre-activations: layer 0 (K 60,
    padded to 64) and layer 1 (K 512) against the 3xTF32 emulation
    (ops/_bwd.py:matmul_3xtf32) of the same operands in f32, against an f64
    product of the bf16 operands in bf16. Both tf32 parts of the activations
    are split in registers (register-A wgmma), so the kernel's products are
    the emulation's up to the order of the f32 sums; one TF32 pass misses the
    same bar by far."""
    from satnerf_torch.ops import _bwd
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk
    from satnerf_torch.ops.fastmath import SINE_ENGINES

    cfg, field, spec, enc = _trunk_case(cuda_device, n=4099)
    spec = dataclasses.replace(spec, layers=2, skips=())
    with torch.no_grad():
        packed = field.packed(dtype)
        packed = {"w0": packed["w0"], "w_mid": packed["w_mid"][:1].contiguous(),
                  "w_skip": packed["w_skip"], "b": packed["b"]}
        x = ff.pack_x(spec, enc, dtype)
        out, acts = trunk._forward(spec, x, packed, True)
        torch.cuda.synchronize()
    f32, f64 = torch.float32, torch.float64
    sin = SINE_ENGINES[spec.sin_mode]
    h0 = sin(spec.w0 * acts[0].float()).to(dtype)
    if dtype == torch.float32:
        ref0 = _bwd.matmul_3xtf32(x, packed["w0"]) + packed["b"][0]
        ref1 = _bwd.matmul_3xtf32(h0, packed["w_mid"][0]) + packed["b"][1]
        one = _bwd.tf32_round(h0) @ _bwd.tf32_round(packed["w_mid"][0]) + packed["b"][1]
    else:
        ref0 = (x.to(f64) @ packed["w0"].to(f64) + packed["b"][0]).to(f32)
        ref1 = (h0.to(f64) @ packed["w_mid"][0].to(f64) + packed["b"][1]).to(f32)
    errs = [_rel(acts[0], ref0.to(dtype)), _rel(acts[1], ref1.to(dtype))]
    record_property("rel_err", errs)
    bar = 1e-5 if dtype == torch.float32 else 2 ** -7  # bf16: one ulp of the store
    assert max(errs) <= bar
    if dtype == torch.float32:
        assert _rel(one, ref1) > 10 * bar


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_kernels_ragged(cuda_device, n, dtype):
    """K1 (both head variants, with residuals) and K3 at point counts around
    the 64-row tile, against their plain versions; two runs bitwise equal."""
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,), mapping=True,
                      use_tj_for_s=True, trunk_impl="pallas", trunk_bwd="stored")
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator().manual_seed(n)
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10).to(cuda_device)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(cuda_device)
    te = torch.randn(n, 4, generator=g).to(cuda_device)
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    resid_tol = 5e-5 if dtype == torch.float32 else 4e-2
    with torch.no_grad():
        packed = field.packed(dtype)
        for heads_on in (True, False):
            spec = dataclasses.replace(fused_field_spec(cfg), heads_on=heads_on)
            x = ff.pack_x(spec, enc, dtype)
            aux = ff.pack_aux(spec, sun, te, None, dtype)
            runs = [ff._forward(spec, x, aux, packed, True) for _ in range(2)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*runs))
            ro, rs, ra = ff._reference_forward(spec, x, aux, packed, True)
            assert float((runs[0][0] - ro).abs().max()) < tol
            assert _rel(runs[0][1], rs) < resid_tol and _rel(runs[0][2], ra) < resid_tol
        k3 = [trunk._forward(spec, x, packed, True) for _ in range(2)]
        torch.cuda.synchronize()
        ref, ref_acts = trunk.fused_trunk_reference(spec, x, packed, True)
    assert all(torch.equal(a, b) for a, b in zip(*k3))
    assert float((k3[0][0].float() - ref.float()).abs().max()) < tol
    assert _rel(k3[0][1], ref_acts) < resid_tol


@pytest.mark.cuda
def test_cuda_trainer_runs_the_kernels_and_resumes_bitwise(cuda_device, tmp_path):
    """The training loop at 4x512 on the card for a handful of steps: every
    step and validation chunk launches K1, K2, K4 and K5 (and K5's backward),
    no plain version runs, and a run stopped at step 4 and resumed ends
    bitwise equal to the uninterrupted one."""
    import numpy as np

    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.models import field as fld
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.checkpoint import export_params
    from satnerf_torch.train.loop import Trainer

    generate_scene(str(tmp_path / "datasets" / "SYN"), n_train=2, n_test=1, img_size=40,
                   n_tie_points=80)

    def trainer(**run):
        cfg = MainConfig(
            RunConfig(dataset_name="SYN", datasets_dp=str(tmp_path / "datasets"),
                      cache_dp=str(tmp_path / "cache"),
                      workspace_dp=str(tmp_path / "training"), max_train_steps=8, seed=0,
                      **run),
            RSSemanticConfig(fc_layers=4, fc_units=512, fc_skips=[2], n_samples=32,
                             batch_size=256, first_beta_epoch=0, use_car_reg_loss=True))
        pipeline = load_pipeline(cfg)
        pipeline.prepare_run()
        pipeline.load_datasets()
        return Trainer(pipeline, log_every=1, device=cuda_device)

    counters = [(ff, "LAUNCHES"), (ff, "HEADS_BWD_LAUNCHES"), (trunk, "LAUNCHES"),
                (comp, "LAUNCHES"), (comp, "BWD_LAUNCHES"), (ff, "PLAIN_CALLS"),
                (trunk, "PLAIN_CALLS"), (trunk, "FWD_PLAIN_CALLS"), (comp, "PLAIN_CALLS"),
                (fld, "PLAIN_CALLS")]
    torch.cuda.synchronize()
    for mod, name in counters:
        setattr(mod, name, 0)
    full = trainer()
    state = full.fit()
    got = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
           for mod, name in counters}
    assert state.step == 8
    drop = full.pipeline.ds_drop_step  # 2
    assert got["field_fused.HEADS_BWD_LAUNCHES"] == got["trunk.LAUNCHES"] == 3 * drop + 2 * (
        8 - drop)
    assert got["composite.BWD_LAUNCHES"] == 2 * drop + (8 - drop)
    assert got["field_fused.LAUNCHES"] > got["trunk.LAUNCHES"]  # + validation chunks
    assert got["composite.LAUNCHES"] > got["composite.BWD_LAUNCHES"]
    assert not any(v for k, v in got.items() if "PLAIN" in k), got
    assert all(np.isfinite(v) for h in full.history for v in h.values())

    first = trainer()
    first.fit(validate_every_epoch=False,
              step_callbacks={4: lambda s, i: first.request_stop()})
    first.cfg.run.resume_from_ckpoint = True
    again = Trainer(first.pipeline, log_every=1, device=cuda_device)
    resumed = again.fit(validate_every_epoch=False)
    pa, pb = export_params(state.params), export_params(resumed.params)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.cuda
def test_cuda_unbuilt_width_raises(cuda_device):
    """A pipeline TOML at a width the kernels are not built for (1,152 wide,
    heads 576: the JAX kernels admit it on their trunk kernel, the port's
    stop at 1,024) resolves to the kernels on the card and raises at their
    launch with the widths that are built, rather than running the
    layer-by-layer field."""
    import os

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models import field as fld
    from satnerf_torch.render.renderer import render_rays
    from satnerf_torch.train.state import init_params

    toml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "pipelines", "rs_semantic.toml")
    rcfg = load_render_config(toml, device=cuda_device, fc_units=1152)
    assert rcfg.field.trunk_impl == "pallas" and rcfg.field.feat == 1152
    params = init_params(torch.Generator().manual_seed(0), rcfg.field, t_vocab=4,
                         device=cuda_device)
    n = 64
    g = torch.Generator().manual_seed(4)
    o = torch.cat([torch.rand(n, 2, generator=g) * 1.6 - 0.8, torch.ones(n, 1)], 1)
    d = torch.tensor([0.0, 0.0, -1.0]).expand(n, 3)
    rays = torch.cat([o, d, torch.zeros(n, 1), torch.full((n, 1), 2.0)], 1).to(cuda_device)
    sun = torch.nn.functional.normalize(torch.tensor([0.2, -0.1, 0.8]), dim=0)
    extras = torch.cat([sun.expand(n, 3), torch.full((n, 1), 3.0)], 1).to(cuda_device)
    before = fld.PLAIN_CALLS
    built = r"built for .*\(128, 256, 384, 512, 640, 768, 896, 1024\)"
    with pytest.raises(ValueError, match=built):
        render_rays(params, rcfg, rays, extras)
    assert fld.PLAIN_CALLS == before


# encoded inputs wider than 64: mapping_pos_n_freq 11, 12, 16 and 21 give
# c_in 66, 72, 96 and 126 (80, 80, 96 and 128 after padding to 16), all
# inside the JAX kernels' c_in <= 128
INPUT_FREQS = (11, 12, 16, 21)


def _input_width_case(cuda_device, n_freq, feat, n=1001):
    """A 4-layer field (skip at 2) ``feat`` wide whose heads K1 takes (half
    the width where that is a multiple of 128, else all of it), at
    ``n_freq`` frequencies, and seeded inputs for K1, K3 and K4."""
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec, use_fused_field

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=feat, skips=(2,), mapping=True,
                      mapping_pos_n_freq=n_freq, use_tj_for_s=True, trunk_impl="pallas",
                      fc_use_full_features=(feat // 2) % 128 != 0)
    assert cfg.xyz_in == 6 * n_freq and use_fused_field(cfg)
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator().manual_seed(n_freq)
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, n_freq)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    te = torch.randn(n, 4, generator=g)
    cot = torch.randn(n, feat, generator=g)
    return field, fused_field_spec(cfg), [t.to(cuda_device) for t in (enc, sun, te, cot)]


# the trunk widths with a fused field (heads half or all of the width, at
# most 512 wide): 640 and 896 have none
K1_FEATS = tuple(f for f in TRUNK_WIDTHS if (f, f // 2) in K1_WIDTHS or (f, f) in K1_WIDTHS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", K1_FEATS)
@pytest.mark.parametrize("n_freq", INPUT_FREQS)
def test_cuda_input_widths_match_plain(cuda_device, n_freq, feat, dtype, record_property):
    """K1 (both head variants, with the "stored" residuals), K3 (with the
    pre-activations) and K4 (both engines, gx included) at encoded inputs
    past 64 wide, at every trunk width, against their plain versions on
    1,001 points (ragged against the 64-row tile), each at the bars of the
    tests above at c_in 60, and bitwise repeatable."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    field, spec, (enc, sun, te, cot) = _input_width_case(cuda_device, n_freq, feat)
    f32 = dtype == torch.float32
    tol, tol_rel = (5e-5, 5e-5) if f32 else (2e-2, 4e-2)
    errs = {}
    with torch.no_grad():
        packed = field.packed(dtype)
        x = ff.pack_x(spec, enc, dtype)
        aux = ff.pack_aux(spec, sun, te, None, dtype)
        assert x.shape[1] == spec.cx and trunk._bwd.padded_k(spec.cx) > 64
        for heads_on in (True, False):
            sp = dataclasses.replace(spec, heads_on=heads_on, trunk_bwd="stored")
            before = ff.LAUNCHES
            out, shared, acts = ff._forward(sp, x, aux, packed, resid=True)
            again = ff._forward(sp, x, aux, packed, resid=True)
            torch.cuda.synchronize()
            assert ff.LAUNCHES == before + 2
            assert all(torch.equal(a, b) for a, b in zip((out, shared, acts), again))
            ref, ref_shared, ref_acts = ff._reference_forward(sp, x, aux, packed, True)
            errs[f"k1/{heads_on}"] = float((out - ref).abs().max())
            assert errs[f"k1/{heads_on}"] < tol, errs
            assert _rel(shared, ref_shared) < tol_rel and _rel(acts, ref_acts) < tol_rel
        before = trunk.FWD_LAUNCHES
        h, pre = trunk._forward(spec, x, packed, True)
        torch.cuda.synchronize()
        assert trunk.FWD_LAUNCHES == before + 1
        ref_h, ref_pre = trunk.fused_trunk_reference(spec, x, packed, True)
        errs["k3"] = float((h.float() - ref_h.float()).abs().max())
        assert errs["k3"] < tol and _rel(pre, ref_pre) < tol_rel, errs
        g = cot.to(dtype)
        for bwd, stored in (("recompute", None), ("stored", pre)):
            sb = dataclasses.replace(spec, trunk_bwd=bwd)
            before = trunk.LAUNCHES
            runs = [trunk.trunk_backward(sb, x, packed, stored, g) for _ in range(2)]
            torch.cuda.synchronize()
            assert trunk.LAUNCHES == before + 2
            assert all(torch.equal(a, b) for a, b in zip(*runs))
            ref = trunk.trunk_backward_reference(sb, x, packed, stored, g)
            assert runs[0][0].shape == x.shape
            errs[f"k4/{bwd}"] = max(_rel(a, b) for a, b in zip(runs[0], ref))
            # bf16: as for K1/K2 above, one-ulp flips of an activation
            assert errs[f"k4/{bwd}"] < (1e-4 if f32 else 2e-2), errs
    record_property("errors", errs)


@pytest.mark.cuda
def test_cuda_input_width_past_128_raises(cuda_device):
    """Past the JAX kernels' c_in <= 128 (22 frequencies: 132) both packages
    route the field layer by layer; K1 and K3 called on such a field raise
    with the widths they take, and K6 raises past its 64."""
    from satnerf_torch.models.field import (Field, FieldConfig, fused_field_spec,
                                            use_fused_field, use_fused_trunk)
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,), mapping=True,
                      mapping_pos_n_freq=22, trunk_impl="pallas")
    assert cfg.xyz_in == 132 and not use_fused_field(cfg) and not use_fused_trunk(cfg)
    spec = fused_field_spec(cfg)
    n, f32 = 70, torch.float32
    x = torch.zeros(n, spec.cx, device=cuda_device)
    aux = torch.zeros(n, spec.aux_w, device=cuda_device)
    launches = (ff.LAUNCHES, trunk.FWD_LAUNCHES, trunk.INTERLEAVED_LAUNCHES)
    with torch.no_grad():
        packed = Field(cfg).to(cuda_device).packed(f32)
        with pytest.raises(ValueError, match="up to 128 wide"):
            ff._forward(spec, x, aux, packed, resid=False)
        with pytest.raises(ValueError, match="up to 128 wide"):
            trunk.fused_trunk(spec, x, packed)
        field, spec66, (enc, *_) = _input_width_case(cuda_device, 11, 512, n=n)
        with pytest.raises(ValueError, match="up to 64 wide"):
            trunk.fused_trunk_interleaved(spec66, ff.pack_x(spec66, enc, f32), field.packed(f32))
    assert (ff.LAUNCHES, trunk.FWD_LAUNCHES, trunk.INTERLEAVED_LAUNCHES) == launches


# head widths past 16 columns: (tau, n_classes) with the aux block 20, 36
# and 128 wide (32, 48 and 128 padded to 16) and the output 32, 32 and 128
# wide, inside the JAX kernels' 3 + 2 tau <= 128 and 9 + n_classes <= 128;
# at tau 62 with the separate semantic t-embedding (every aux column in use)
HEAD_CASES = ((7, 8), (16, 12), (62, 119))


def _head_width_case(cuda_device, tau, n_classes, feat, fl, n=1001):
    """A 4-layer field (skip at 2) with heads ``fl`` wide, a t-embedding
    ``tau`` wide and ``n_classes`` classes, and seeded inputs for K1, K2 and
    K4 (the gradient of the raw output columns among them)."""
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec, use_fused_field
    from satnerf_torch.ops import field_fused as ff

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=feat, skips=(2,), mapping=True,
                      use_tj_for_s=True, use_separate_tj_for_semantic=tau == 62,
                      t_embedding_tau=tau, n_classes=n_classes, trunk_impl="pallas",
                      fc_use_full_features=fl == feat)
    assert cfg.feat_last == fl and use_fused_field(cfg)
    field = Field(cfg, generator=torch.Generator().manual_seed(tau)).to(cuda_device)
    spec = fused_field_spec(cfg)
    g = torch.Generator().manual_seed(n_classes)
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    te, ts = torch.randn(n, tau, generator=g), torch.randn(n, tau, generator=g)
    g_out = torch.randn(n, spec.out_w, generator=g)
    enc, sun, te, ts, g_out = (t.to(cuda_device) for t in (enc, sun, te, ts, g_out))
    return field, spec, lambda dt: (ff.pack_x(spec, enc, dt),
                                    ff.pack_aux(spec, sun, te, ts, dt)), g_out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat,fl", [(256, 128), (512, 256), (512, 512), (768, 384),
                                     (1024, 512)])
@pytest.mark.parametrize("tau,n_classes", HEAD_CASES)
def test_cuda_head_widths_match_plain(cuda_device, tau, n_classes, feat, fl, dtype,
                                      record_property):
    """K1 (both head variants, with the residuals), K2 and K4 at t-embeddings
    7-62 wide and 8-119 classes against their plain versions on 1,001 points
    (ragged against the 64-row tile), at the bars of the tests above, and
    bitwise repeatable; at 768 and 1,024 wide too (H in global memory)."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    field, spec, inputs, g_out = _head_width_case(cuda_device, tau, n_classes, feat, fl)
    assert spec.out_w > 16 and spec.aux_pad > 16
    f32 = dtype == torch.float32
    errs = {}
    with torch.no_grad():
        packed = field.packed(dtype)
        x, aux = inputs(dtype)
        for heads_on in (True, False):
            sp = dataclasses.replace(spec, heads_on=heads_on)
            before = ff.LAUNCHES
            runs = [ff._forward(sp, x, aux, packed, resid=True) for _ in range(2)]
            torch.cuda.synchronize()
            assert ff.LAUNCHES == before + 2
            assert all(torch.equal(a, b) for a, b in zip(*runs) if a is not None)
            out, shared, _ = runs[0]
            assert out.shape == (x.shape[0], spec.out_w)
            ref, ref_shared, _ = ff._reference_forward(sp, x, aux, packed, True)
            errs[f"k1/{heads_on}"] = float((out - ref).abs().max())
            assert errs[f"k1/{heads_on}"] < (5e-5 if f32 else 2e-2), errs
            assert _rel(shared, ref_shared) < (5e-5 if f32 else 4e-2)
            if not heads_on:  # the semantic groups hold the bias alone: 0
                assert torch.all(out[:, 16:] == 0)
            runs = []
            for _ in range(2):
                before = (ff.HEADS_BWD_LAUNCHES, trunk.LAUNCHES)
                h = ff.heads_backward(sp, shared, aux, g_out, packed)
                t = trunk.trunk_backward(sp, x, packed, None, h[0])
                torch.cuda.synchronize()
                assert (ff.HEADS_BWD_LAUNCHES, trunk.LAUNCHES) == (before[0] + 1,
                                                                    before[1] + 1)
                runs.append([h[0], h[1], *h[2].values(), *t])
            assert all(torch.equal(a, b) for a, b in zip(*runs))
            assert runs[0][1].shape == aux.shape
            ref_h = ff.heads_backward_reference(sp, shared, aux, g_out, packed)
            ref_t = trunk.trunk_backward_reference(sp, x, packed, None, ref_h[0])
            ref = [ref_h[0], ref_h[1], *ref_h[2].values(), *ref_t]
            errs[f"k2_k4/{heads_on}"] = max(_rel(a, b) for a, b in zip(runs[0], ref))
            # bf16: as for K1 (chip_smoke.py TOL_FIELD), one-ulp flips of an activation
            assert errs[f"k2_k4/{heads_on}"] < (1e-4 if f32 else 2e-2), errs
    record_property("errors", errs)


@pytest.mark.cuda
def test_cuda_head_widths_past_the_jax_bounds_raise(cuda_device):
    """Past the JAX kernels' bounds (3 + 2 tau <= 128, 9 + n_classes <= 128)
    the field has no spec, so neither route runs; the kernels' wrappers
    refuse an output or aux block past 128 columns, and launch nothing."""
    from satnerf_torch.models.field import FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff

    for kw in ({"t_embedding_tau": 63}, {"n_classes": 120}):
        cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,), mapping=True,
                          trunk_impl="pallas", **kw)
        with pytest.raises(ValueError, match="exceeds"):
            fused_field_spec(cfg)
    field, spec, inputs, g_out = _head_width_case(cuda_device, 62, 119, 512, 256, n=70)
    wide = object.__new__(ff.FieldSpec)  # past the bound, as a caller could build it
    for f in dataclasses.fields(ff.FieldSpec):
        object.__setattr__(wide, f.name, getattr(spec, f.name))
    object.__setattr__(wide, "n_classes", 120)
    x, aux = inputs(torch.float32)
    launches = (ff.LAUNCHES, ff.HEADS_BWD_LAUNCHES)
    with torch.no_grad():
        packed = field.packed(torch.float32)
        with pytest.raises(ValueError, match="128 output columns"):
            ff._forward(wide, x, aux, packed, resid=False)
        shared = torch.zeros(x.shape[0], spec.feat, device=cuda_device)
        with pytest.raises(ValueError, match="past 128 / 128"):
            ff.heads_backward(wide, shared, aux, torch.zeros(x.shape[0], 144,
                                                             device=cuda_device), packed)
    assert (ff.LAUNCHES, ff.HEADS_BWD_LAUNCHES) == launches


@pytest.fixture
def cuda_run(cuda_device, tmp_path):
    """A 4x512 port run trained 8 steps on the card (its validation saves
    ``best``)."""
    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    generate_scene(str(tmp_path / "datasets" / "SYN"), n_train=2, n_test=1, img_size=40,
                   n_tie_points=80)
    cfg = MainConfig(
        RunConfig(dataset_name="SYN", datasets_dp=str(tmp_path / "datasets"),
                  cache_dp=str(tmp_path / "cache"), workspace_dp=str(tmp_path / "training"),
                  max_train_steps=8, num_sanity_val_steps=0, seed=0),
        RSSemanticConfig(fc_layers=4, fc_units=512, fc_skips=[2], n_samples=32,
                         batch_size=256, first_beta_epoch=0))
    pipeline = load_pipeline(cfg)
    pipeline.prepare_run()
    pipeline.load_datasets()
    Trainer(pipeline, log_every=8, device=cuda_device).fit()
    return cfg.run.run_dp


def _reset_counts():
    from satnerf_torch.models import field as fld
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    counters = {"k1": (ff, "LAUNCHES"), "k2": (ff, "HEADS_BWD_LAUNCHES"),
                "k3": (trunk, "FWD_LAUNCHES"), "k4": (trunk, "LAUNCHES"),
                "k5": (comp, "LAUNCHES"), "k5_bwd": (comp, "BWD_LAUNCHES"),
                "k6": (trunk, "INTERLEAVED_LAUNCHES"),
                "plain_field": (ff, "PLAIN_CALLS"), "plain_trunk": (fld, "PLAIN_CALLS"),
                "plain_k3": (trunk, "FWD_PLAIN_CALLS"), "plain_k4": (trunk, "PLAIN_CALLS"),
                "plain_k5": (comp, "PLAIN_CALLS")}
    torch.cuda.synchronize()
    for mod, name in counters.values():
        setattr(mod, name, 0)
    return lambda: {k: getattr(mod, name) for k, (mod, name) in counters.items()}


@pytest.mark.cuda
def test_cuda_eval_battery_runs_the_kernels_and_matches_the_cpu(cuda_device, cuda_run,
                                                                tmp_path):
    """``eval_all`` on the card: K1 and K5 once per chunk of every image, no
    plain version, and every results.json value within one unit of its last
    printed digit of the same battery on the CPU."""
    import json
    import os

    from satnerf_torch.device import disable_tf32
    from satnerf_torch.eval.eval import eval_all

    counts = _reset_counts()
    try:
        eval_all(cuda_run, str(tmp_path / "card"), isolate="inline", chunk=1024,
                 device=cuda_device)
    finally:
        disable_tf32()
    got = counts()
    # train split 2 images, test split 2 (the prepended train view): 1,600
    # rays each, 2 chunks of 1,024
    assert got["k1"] == got["k5"] == 4 * 2 and got["k3"] == 0, got
    assert not any(v for k, v in got.items() if k.startswith("plain")), got
    eval_all(cuda_run, str(tmp_path / "cpu"), isolate="inline", chunk=1024, device="cpu")
    name = os.path.basename(cuda_run)
    for split in ("train", "test"):
        for kind in ("eval", "eval_semantic"):
            card, cpu = (json.load(open(os.path.join(str(tmp_path / d), name, kind, split,
                                                     "results.json")))
                         for d in ("card", "cpu"))
            _within_printed_digits(card, cpu, f"{kind}/{split}")


def _within_printed_digits(card, cpu, path: str):
    """Every value of two results.json trees within one unit of its last
    printed digit: PSNR 0.01, SSIM, MAE and the confusion matrices 1e-3,
    the semantic scores 1e-4."""
    if isinstance(cpu, dict):
        assert set(card) == set(cpu), path
        for k in cpu:
            _within_printed_digits(card[k], cpu[k], f"{path}/{k}")
    elif isinstance(cpu, list):
        assert len(card) == len(cpu), path
        for i, (a, b) in enumerate(zip(card, cpu)):
            _within_printed_digits(a, b, f"{path}[{i}]")
    elif cpu is None:
        assert card is None, path
    else:
        low = path.lower()
        bar = 0.01 if "psnr" in low else (
            1e-3 if any(k in low for k in ("ssim", "mae", "confusion")) else 1e-4)
        assert abs(float(card) - float(cpu)) <= bar * 1.000001, (path, card, cpu)


@pytest.mark.cuda
def test_cuda_http_render_runs_the_kernels_and_matches_the_cpu(cuda_device, cuda_run):
    """``POST /render`` on the card: one K1 and one K5 launch per 1,024-ray
    chunk, no plain version, the PNG equal to the served rgb, which agrees
    with the CPU service within the serve bar (1e-4)."""
    import json
    import urllib.request

    import numpy as np

    from satnerf_torch.io.png import decode_png
    from satnerf_torch.serve.http_server import serve_in_thread
    from satnerf_torch.serve.service import RenderService

    svc = RenderService.from_run(cuda_run, chunk=1024, device=cuda_device)
    name = svc.view_names()[0]
    counts = _reset_counts()
    server, port = serve_in_thread(svc)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                     data=json.dumps({"view": name}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            png = decode_png(resp.read())
    finally:
        server.shutdown()
        server.server_close()
    got = counts()
    assert got["k1"] == got["k5"] == 2 and got["k3"] == 0, got  # 1,600 rays
    assert not any(v for k, v in got.items() if k.startswith("plain")), got
    served = svc.render(name)
    np.testing.assert_array_equal(png, (served["rgb"] * 255).astype(np.uint8))
    ref = RenderService.from_run(cuda_run, chunk=1024, device="cpu").render(name)
    assert float(np.abs(served["rgb"] - ref["rgb"]).max()) <= 1e-4
    assert float(np.abs(served["depth"] - ref["depth"]).max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_trains_on_a_dataset_the_port_prepared(cuda_device, tmp_path):
    """A small DFC2019 Track-3 distribution (4 views of 96²) through the
    port's ``create_dataset`` (cropping, the native BA, masks on the cropped
    grid), then 6 steps at 4x512 on the card: every step launches K1, K2,
    K4, K5 and K5's backward as scheduled, no plain version runs."""
    import numpy as np

    import torch_dfc_case as dfc
    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.data_prep.create_dataset import create_dataset
    from satnerf_torch.data_prep.dataset_config import DatasetConfig
    from satnerf_torch.models import field as fld
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    dist = dfc.write_distribution(str(tmp_path / "raw"), 4, 96, n_tie_points=120)
    out = str(tmp_path / "datasets" / "JAX_068")
    create_dataset(DatasetConfig(general=dfc.general(dist, out), steps=dfc.PREP_STEPS[:2]))
    dfc.crop_masks(dist, out, str(tmp_path / "masks"))
    create_dataset(DatasetConfig(general=dfc.general(dist, out, str(tmp_path / "masks"),
                                                     split_mode="fixed", n_test=1),
                                 steps=dfc.PREP_STEPS))
    cfg = MainConfig(
        RunConfig(dataset_name="JAX_068", datasets_dp=str(tmp_path / "datasets"),
                  cache_dp=str(tmp_path / "cache"), workspace_dp=str(tmp_path / "training"),
                  max_train_steps=6, num_sanity_val_steps=0, seed=0),
        RSSemanticConfig(fc_layers=4, fc_units=512, fc_skips=[2], n_samples=32,
                         batch_size=256, first_beta_epoch=0))
    pipeline = load_pipeline(cfg)
    pipeline.prepare_run()
    pipeline.load_datasets()
    assert pipeline.datasets["depth"].combined["rays"].shape[0] > 0
    counters = [(ff, "LAUNCHES"), (ff, "HEADS_BWD_LAUNCHES"), (trunk, "LAUNCHES"),
                (comp, "LAUNCHES"), (comp, "BWD_LAUNCHES"), (ff, "PLAIN_CALLS"),
                (trunk, "PLAIN_CALLS"), (trunk, "FWD_PLAIN_CALLS"), (comp, "PLAIN_CALLS"),
                (fld, "PLAIN_CALLS")]
    torch.cuda.synchronize()
    for mod, name in counters:
        setattr(mod, name, 0)
    trainer = Trainer(pipeline, log_every=1, device=cuda_device)
    state = trainer.fit(validate_every_epoch=False)
    got = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
           for mod, name in counters}
    drop = min(pipeline.ds_drop_step, 6)
    assert state.step == 6
    assert got["field_fused.LAUNCHES"] == got["field_fused.HEADS_BWD_LAUNCHES"] == \
        got["trunk.LAUNCHES"] == 3 * drop + 2 * (6 - drop), got
    assert got["composite.LAUNCHES"] == got["composite.BWD_LAUNCHES"] == \
        2 * drop + (6 - drop), got
    assert not any(v for k, v in got.items() if "PLAIN" in k), got
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())


def _trained_through_the_kernels(got: dict, trunk_only: bool = False) -> None:
    """K1, K2, K4, K5 and K5's backward launched; with ``trunk_only`` (heads
    narrower than 128, as the examples' 2 x 128) K3 and K4 and the heads
    layer by layer, with no K1 or K2."""
    if trunk_only:
        assert got["k3"] > 0 and got["k4"] > 0 and got["k1"] == got["k2"] == 0, got
    else:
        assert got["k1"] > 0 and got["k2"] == got["k4"] > 0 and got["k3"] == 0, got
    assert got["k5"] > 0 and got["k5_bwd"] > 0 and got["k6"] == 0, got
    assert not any(v for k, v in got.items() if k.startswith("plain")), got


@pytest.mark.cuda
def test_cuda_examples_run_on_the_card(cuda_device, tmp_path, monkeypatch, capsys):
    """The four examples on the card, as ``python -m
    satnerf_torch.examples.<name>`` runs them (their ``main``, in this
    process), at the JAX package's 2 x 128: 01 trains through K3, K4, K5 and
    K5's backward (heads 64 wide: layer by layer) with no plain version; 02's
    battery and 03's three views render through K3 and K5 once per chunk;
    04's checkpoint round trip is exact."""
    import glob
    import importlib
    import os

    from satnerf_torch.device import disable_tf32

    monkeypatch.setenv("SATNERF_EXAMPLES_OUT", str(tmp_path))
    monkeypatch.setenv("SATNERF_EXAMPLES_STEPS", "12")
    monkeypatch.setenv("SATNERF_EXAMPLES_IMG", "32")
    launches = {}
    try:
        for name in ("01_train_synthetic", "02_eval_battery", "03_relight_views",
                     "04_reference_interop"):
            counts = _reset_counts()
            assert importlib.import_module(f"satnerf_torch.examples.{name}").main(
                ["--device", "cuda"]) == 0
            launches[name] = counts()
    finally:
        disable_tf32()  # the eval loader applied the run's matmul precision
    out = capsys.readouterr().out
    _trained_through_the_kernels(launches["01_train_synthetic"], trunk_only=True)
    # 02: the test split (a prepended train view and one test view of 32 x 32,
    # one 16,384-ray chunk each); 03: three views of 32 x 32 at chunk 4,096
    for name, chunks in (("02_eval_battery", 2), ("03_relight_views", 3)):
        got = launches[name]
        assert got["k3"] == got["k5"] == chunks and got["k1"] == 0, (name, got)
        assert not any(v for k, v in got.items() if k.startswith("plain")), (name, got)
    assert "PSNR" in out and out.count(" wrote ") == 3 and "round trip exact" in out
    assert len(glob.glob(os.path.join(str(tmp_path), "relight", "*.png"))) == 3


@pytest.mark.cuda
def test_cuda_ours_train_eval_and_sin_swap_run_the_kernels(cuda_device, tmp_path):
    """``ours_train_eval`` on the card (8 x 512 in bf16, 16 steps, a horizon
    at 8): its launches by the trainer's schedule, no plain version, every
    metric finite; then ``sin_swap_eval`` of the run under poly, poly5 and
    poly7f: one K1 launch per chunk under each engine, no plain field."""
    import json
    import math
    import os

    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.tools import ours_train_eval, sin_swap_eval

    scene = str(tmp_path / "datasets" / "SYN")
    generate_scene(scene, n_train=2, n_test=1, img_size=32, n_tie_points=80)
    out = str(tmp_path / "poly_s0")
    counts = _reset_counts()
    assert ours_train_eval.main([scene, out, "--steps", "16", "--batch", "256", "--units",
                                 "512", "--n-samples", "16", "--eval-at", "8",
                                 "--device", "cuda"]) == 0
    _trained_through_the_kernels(counts())
    for name in ("results.json", "results_step8.json"):
        with open(os.path.join(out, name)) as f:
            r = json.load(f)
        assert all(math.isfinite(r[k]) for k in ("psnr", "ssim", "mae", "acc", "miou")), r
    (run,) = os.listdir(os.path.join(out, "training"))
    counts = _reset_counts()
    try:
        assert sin_swap_eval.main([os.path.join(out, "training", run), "--sins",
                                   "poly,poly5,poly7f", "--out", str(tmp_path / "swap"),
                                   "--device", "cuda"]) == 0
    finally:
        disable_tf32()
    with open(str(tmp_path / "swap" / "summary.json")) as f:
        rows = json.load(f)
    assert [r["eval_sin"] for r in rows] == ["poly", "poly5", "poly7f"]
    assert all(r["field_kernel_launches"] == 1 and r["plain_field_calls"] == 0
               for r in rows), rows
    assert counts()["plain_field"] == 0


def _chip_smoke():
    """The repository's chip_smoke.py, loaded by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# trunks past 512 wide (H in global memory, csrc/trunk_tc.cuh kGlobalH):
# the TOML's 8 layers, heads feat / 2 (K1 and K2 at 768 and 1,024, K3 with
# the heads layer by layer at 640 and 896)
WIDE_FEATS = (640, 768, 896, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_cuda_wide_widths_match_plain(cuda_device, feat, dtype, record_property):
    """K3 and K4 (both engines) at every width past 512, K1 (both head
    variants, with its residuals) and K2 where the fused field takes the
    width, against their plain versions at n = 1, 63, 65 and 65,537 within
    chip_smoke.py's bars, each run twice bitwise equal
    (``chip_smoke.width_kernel_checks``; a bf16 output past its bar held by
    the bf16 yardstick, ``_fwd_check``). Prints the errors and the
    yardstick's readings (``-rP`` shows them)."""
    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models.field import Field, fused_field_spec, use_fused_field

    smoke = _chip_smoke()
    rcfg = load_render_config(smoke.PIPELINE_TOML, device=cuda_device, trunk_impl="pallas",
                              fc_units=feat)
    fcfg = rcfg.field
    fused = use_fused_field(fcfg)
    assert fused == (feat in (768, 1024)) and fcfg.feat_last == feat // 2
    field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    spec = fused_field_spec(fcfg)
    inputs = smoke._width_inputs(fcfg, 65_537, feat, cuda_device)
    notes, errs = [], {}
    with torch.no_grad():
        packed = field.packed(getattr(torch, dtype))
        for n in (1, 63, 65, 65_537):
            for route in ((True, False) if fused else (False,)):
                errs.update({f"n{n}/{k}": e for k, e in smoke.width_kernel_checks(
                    f"{feat}", spec, route, packed, inputs, dtype, n, notes).items()})
    record_property("errors", errs)
    record_property("notes", notes)
    print(json.dumps({"worst": max(errs.items(), key=lambda kv: kv[1]), "notes": notes}))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skips", [(1, 2, 3, 4, 5, 6, 7), (2, 5)], ids=["skips1-7", "skips2-5"])
def test_cuda_k4_any_skip_set_matches_plain(cuda_device, skips, dtype, record_property):
    """K3 and K4 (both engines, gx chained past MAX_PRODS products) at 8 x 256
    with 7 and 2 skips against their plain versions, two runs bitwise."""
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec

    smoke = _chip_smoke()
    fcfg = FieldConfig(variant="rs_semantic", layers=8, feat=256, skips=skips, mapping=True,
                       trunk_impl="pallas")
    field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    inputs = smoke._width_inputs(fcfg, 4097, len(skips), cuda_device)
    with torch.no_grad():
        errs = smoke.width_kernel_checks("skips", fused_field_spec(fcfg), False,
                                         field.packed(getattr(torch, dtype)), inputs, dtype,
                                         4097, [])
    record_property("errors", errs)


@pytest.mark.cuda
@pytest.mark.parametrize("feat,layers,fused", [(1024, 25, False), (640, 33, False),
                                               (1024, 17, True), (768, 23, True)])
def test_cuda_trunk_past_the_plan_raises_naming_its_depth(cuda_device, feat, layers, fused):
    """A trunk one layer deeper than K1's or K3's plan of 96 weight passes
    holds at its width raises ValueError naming that depth (K3: 24 at 1,024,
    32 at 640; K1 at 16 classes' worth of output: 16 at (1,024, 512), 22 at
    (768, 384)), before any launch."""
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cfg = FieldConfig(variant="rs_semantic", layers=layers, feat=feat, skips=(2,), mapping=True,
                      trunk_impl="pallas",
                      **({} if fused else {"use_separate_beta_for_s": True}))
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    spec = fused_field_spec(cfg)
    x = torch.zeros((70, spec.cx), device=cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match=f"at most {layers - 1} layers"):
        if fused:
            aux = torch.zeros((70, spec.aux_w), device=cuda_device)
            ff.fused_field(spec, x, aux, field.packed(torch.float32))
        else:
            trunk.fused_trunk(spec, x, field.packed(torch.float32))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_at_trained_weights(cuda_device, tmp_path, record_property):
    """``chip_smoke.trained_audit`` on a short trained state (2 x 512 in bf16,
    100 steps on a 2 + 1-view 32x32 scene: the beta gate, car-reg and the
    depth drop behind it): one batch of 512 + 512 depth rays through the
    kernels and through their plain versions on the card (TF32 off), in f32
    and in bf16; every loss term, K1 output, K5 weight and gradient within
    chip_smoke.py's TOL_AUDIT."""
    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    smoke = _chip_smoke()
    generate_scene(str(tmp_path / "datasets" / "SYN"), n_train=2, n_test=1, img_size=32,
                   n_tie_points=300)
    run = RunConfig(dataset_name="SYN", datasets_dp=str(tmp_path / "datasets"),
                    cache_dp=str(tmp_path / "cache"), workspace_dp=str(tmp_path / "training"),
                    max_train_steps=100, check_val_every_n_epoch=1000, num_sanity_val_steps=0,
                    seed=0)
    pipe = RSSemanticConfig(n_samples=32, fc_layers=2, fc_units=512, fc_skips=[1],
                            batch_size=512, ignore_car_index=False, use_car_reg_loss=True,
                            car_reg_loss_start=3, lambda_c=1.0, compute_dtype="bfloat16")
    pipeline = load_pipeline(MainConfig(run, pipe))
    pipeline.prepare_run()
    pipeline.load_datasets()
    state = Trainer(pipeline, device="cuda").fit(validate_every_epoch=False)
    assert state.step == 100 > pipeline.ds_drop_step
    audit = smoke.trained_audit(pipeline, state.params, state.step, 512, 512, cuda_device)
    worst = smoke.audit_worst(audit)
    record_property("worst", worst)
    assert audit["rays"] == 512 and audit["depth_rays"] > 0
    failures = smoke.audit_failures(audit)
    assert not failures, (failures, worst)


@pytest.mark.cuda
def test_cuda_trained_audit_holds_each_field_against_its_own(cuda_device, tmp_path,
                                                            record_property):
    """``chip_smoke.trained_audit`` on a hierarchical state (2 x 512 in bf16,
    32 + 32 samples, a fine field apart, ``remat_chunks`` 2; 60 steps on a
    2 + 1-view 32x32 scene through the beta gate, car-reg and the depth
    drop), whose fine field differs from the coarse one: both fields
    evaluated, and each K1 output of each within TOL_AUDIT's field bar in
    f32 and in bf16, held against the plain version of its own field."""
    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    smoke = _chip_smoke()
    generate_scene(str(tmp_path / "datasets" / "SYN"), n_train=2, n_test=1, img_size=32,
                   n_tie_points=300)
    run = RunConfig(dataset_name="SYN", datasets_dp=str(tmp_path / "datasets"),
                    cache_dp=str(tmp_path / "cache"), workspace_dp=str(tmp_path / "training"),
                    max_train_steps=60, check_val_every_n_epoch=1000, num_sanity_val_steps=0,
                    seed=0)
    pipe = RSSemanticConfig(n_samples=32, n_importance=32, use_fine_network=True,
                            remat_chunks=2, fc_layers=2, fc_units=512, fc_skips=[1],
                            batch_size=512, ignore_car_index=False, use_car_reg_loss=True,
                            car_reg_loss_start=3, lambda_c=1.0, compute_dtype="bfloat16")
    pipeline = load_pipeline(MainConfig(run, pipe))
    pipeline.prepare_run()
    pipeline.load_datasets()
    state = Trainer(pipeline, device=cuda_device).fit(validate_every_epoch=False)
    assert state.step == 60 > pipeline.ds_drop_step
    coarse, fine = state.params["field"].fc_net[0].weight, state.params["fine"].fc_net[0].weight
    assert float((coarse - fine).abs().max()) > 1e-2 * float(coarse.abs().max())
    audit = smoke.trained_audit(pipeline, state.params, state.step, 512, 512, cuda_device)
    record_property("worst", smoke.audit_worst(audit))
    assert audit["field_evaluations"]["field"] > 0 and audit["field_evaluations"]["fine"] > 0
    for engine in ("float32", "bfloat16"):
        bar = smoke.TOL_AUDIT[engine]["field"]
        errs = audit[engine]["field"]
        for key in ("field", "fine"):
            mine = {k: e for k, e in errs.items() if k.split(".")[1] == key}
            assert mine, (engine, key)
            beyond = {k: e for k, e in mine.items() if not e <= bar}
            assert not beyond, (engine, key, beyond)


# each measurement script at a small window: (its module, its call)
TOOL_RUNS = {
    "bench": ({"SATNERF_BENCH_BATCH": "1024"}, lambda mod: mod.main(2)),
    "render_bench": ({"SATNERF_RENDER_CHUNK": "1024", "SATNERF_RENDER_SCAN": "2"},
                     lambda mod: mod.main()),
    "speed_of_light": ({}, lambda mod: mod.main(["--batch", "1024", "--scan", "2",
                                                 "--sc-stride", "2"])),
    "feed_rate": ({}, lambda mod: mod.main(["--rays", "1000000", "--steps", "50"])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tool", sorted(TOOL_RUNS))
def test_cuda_measurement_scripts_run_the_kernels(cuda_device, tool, monkeypatch):
    """``satnerf_torch.bench`` and the three measurement tools at a small
    window: a finite positive rate or time, the kernels launched (none by
    feed_rate, which copies indices only) and no plain version."""
    import importlib
    import math
    import os

    from satnerf_torch.models import field as field_mod
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    env, run = TOOL_RUNS[tool]
    for k in list(os.environ):
        if k.startswith(("SATNERF_BENCH_", "SATNERF_RENDER_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mod = importlib.import_module("satnerf_torch.bench" if tool == "bench"
                                  else f"satnerf_torch.tools.{tool}")
    counters = ((ff, "LAUNCHES"), (comp, "LAUNCHES"), (ff, "PLAIN_CALLS"),
                (trunk, "PLAIN_CALLS"), (comp, "PLAIN_CALLS"), (field_mod, "PLAIN_CALLS"))
    before = [getattr(m, n) for m, n in counters]
    out = run(mod)
    k1, k5, *plain = (getattr(m, n) - b for (m, n), b in zip(counters, before))
    if tool == "speed_of_light":
        values = [r["ms"] for r in out["rows"]]
    else:
        values = [out["rays_per_s" if tool == "feed_rate" else "value"]]
    assert all(math.isfinite(v) and v > 0 for v in values), out
    assert not any(plain), plain
    if tool == "feed_rate":
        assert k1 == k5 == 0
    else:
        assert k1 > 0 and k5 > 0, (k1, k5)


def _dispatch_trainer(tmp_path, spd: int, hier: bool, name: str = "", **run):
    """A Trainer on a generated 40 x 40 scene (2 train views: 3,200 rays, an
    epoch of 8 steps at 400 rays) at 4 x 512 for 16 steps: the depth drop at
    8 (``depth_supervision_drop`` 0.5) and the beta gate at epoch 1, so with
    K = 8 each variant runs one block (a warm-up step, the capture, 7
    replays); ``hier``: Path B's hierarchical pass."""
    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    scene = tmp_path / "datasets" / "SYN"
    if not scene.exists():
        generate_scene(str(scene), n_train=2, n_test=1, img_size=40, n_tie_points=80)
    hier_kw = dict(n_importance=32, use_fine_network=True, remat_chunks=2,
                   sc_stride=2) if hier else {}
    cfg = MainConfig(
        RunConfig(dataset_name="SYN", datasets_dp=str(tmp_path / "datasets"),
                  cache_dp=str(tmp_path / "cache"),
                  workspace_dp=str(tmp_path / f"training_k{spd}{name}"), max_train_steps=16,
                  num_sanity_val_steps=0, seed=0, steps_per_dispatch=spd, **run),
        RSSemanticConfig(fc_layers=4, fc_units=512, fc_skips=[2], n_samples=32,
                         batch_size=400, first_beta_epoch=1, use_car_reg_loss=True,
                         car_reg_loss_start=1, depth_supervision_drop=0.5, **hier_kw))
    pipeline = load_pipeline(cfg)
    pipeline.prepare_run()
    pipeline.load_datasets()
    return Trainer(pipeline, log_every=8, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hier", [False, True], ids=["flagship", "path_b"])
def test_cuda_steps_per_dispatch_is_bitwise_per_step(cuda_device, tmp_path, hier):
    """K = 8 (blocks of replays of one captured step) against K = 1 (eager
    steps) from the same seed across the depth drop and the beta gate: the
    parameters, Adam's moments and count and the logged metrics bitwise
    equal; each variant captured once and replayed 7 times. A K = 8 run
    stopped at step 4 and resumed lands on the same parameters."""
    from satnerf_torch.train.checkpoint import export_params
    from satnerf_torch.train.loop import Trainer

    runs = {}
    for spd in (1, 8):
        trainer = _dispatch_trainer(tmp_path, spd, hier)
        state = trainer.fit(validate_every_epoch=False)
        runs[spd] = (trainer, state)
    (t1, s1), (t8, s8) = runs[1], runs[8]
    assert s1.step == s8.step == 16 and t8.pipeline.ds_drop_step == 8
    pa, pb = export_params(s1.params), export_params(s8.params)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    o1, o8 = s1.optimizer, s8.optimizer
    assert all(torch.equal(a, b) for a, b in zip(o1.exp_avg + o1.exp_avg_sq, o8.exp_avg + o8.exp_avg_sq))
    assert torch.equal(o1.count, o8.count) and int(o8.count) == 16
    assert t1.history == t8.history and len(t8.history) == 2
    assert t8.history[0]["beta_loss_activated"] == 0.0
    assert t8.history[1]["beta_loss_activated"] == 1.0
    assert "depth_loss_activated" in t8.history[0] and "depth_loss_activated" not in t8.history[1]
    stats = t8.dispatch.graph_stats()
    assert all(v["replays"] == 7 and v["eager_steps"] == 1 for v in stats.values()), stats
    assert all(v["eager_steps"] == 8 for v in t1.dispatch.graph_stats().values())

    first = _dispatch_trainer(tmp_path, 8, hier, name="_resume")
    assert first.fit(validate_every_epoch=False,
                     step_callbacks={4: lambda s, i: first.request_stop()}).step == 4
    first.cfg.run.resume_from_ckpoint = True
    again = Trainer(first.pipeline, log_every=8, device=cuda_device)
    resumed = again.fit(validate_every_epoch=False)
    pr = export_params(resumed.params)
    assert resumed.step == 16 and all(torch.equal(pa[k], pr[k]) for k in pa)
    assert torch.equal(resumed.optimizer.count, o1.count)


@pytest.mark.cuda
def test_cuda_capture_unsafe_step_raises(cuda_device, tmp_path, monkeypatch):
    """A step that reads a value back to the host (``.item()``) trains
    eagerly but cannot be captured: with K = 8 ``Trainer.fit`` raises at the
    capture, after the one warm-up step, and runs no block eagerly."""
    from satnerf_torch.train import losses

    psnr = losses.psnr

    def reads_back(*args, **kwargs):
        out = psnr(*args, **kwargs)
        out.item()
        return out

    monkeypatch.setattr(losses, "psnr", reads_back)
    trainer = _dispatch_trainer(tmp_path, 8, hier=False)
    with pytest.raises(RuntimeError):
        trainer.fit(validate_every_epoch=False)
    depth = trainer.dispatch.variants[True]
    assert depth.eager_steps == 1 and depth.graph.replays == 0 and depth.graph.graph is None
    assert not trainer.history
    assert float(torch.ones(4, device=cuda_device).sum()) == 4.0  # the card still works


@pytest.mark.cuda
def test_cuda_steps_per_dispatch_with_data_parallel_raises(cuda_device, tmp_path):
    trainer = _dispatch_trainer(tmp_path, 8, hier=False, data_parallel=2)
    with pytest.raises(ValueError, match="steps_per_dispatch 8 under data parallelism"):
        trainer.fit(validate_every_epoch=False)


@pytest.mark.cuda
def test_cuda_adam_is_torch_adam_bitwise(cuda_device):
    """The port's Adam, whose step-dependent scalars are device tensors (so a
    CUDA graph can capture it), against ``torch.optim.Adam`` (foreach, not
    capturable) on the card: 60 steps on 40 tensors of the flagship field's
    shapes, gradients of 1e-3 to 1e-1, the learning rate changing every 7
    steps; every parameter and moment bitwise equal."""
    from satnerf_torch.train.state import Adam

    g = torch.Generator().manual_seed(0)
    shapes = [(512, 63), (512,), (512, 512), (512, 575), (256, 512), (4, 256), (1, 256),
              (50, 4)] * 5
    start = [torch.randn(s, generator=g) * 0.1 for s in shapes]
    ref = [p.clone().to(cuda_device).requires_grad_(True) for p in start]
    mine = [p.clone().to(cuda_device) for p in start]
    opt_ref = torch.optim.Adam(ref, lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
    opt = Adam(mine)
    for step in range(60):
        grads = [(torch.randn(s, generator=g) * 10 ** (-3 + 2 * torch.rand(1, generator=g))
                  ).to(cuda_device) for s in shapes]
        lr = 5e-4 * 0.9 ** (step // 7)
        for p, q, gr in zip(ref, mine, grads):
            p.grad, q.grad = gr, gr.clone()
        opt_ref.param_groups[0]["lr"] = lr
        opt_ref.step()
        opt.feed(lr)
        opt.step()
        opt.t += 1
    assert int(opt.count) == 60
    for i, (p, q) in enumerate(zip(ref, mine)):
        st = opt_ref.state[p]
        assert torch.equal(p.detach(), q), i
        assert torch.equal(st["exp_avg"], opt.exp_avg[i]), i
        assert torch.equal(st["exp_avg_sq"], opt.exp_avg_sq[i]), i
