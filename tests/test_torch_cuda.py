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

import pytest
import torch


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
@pytest.mark.parametrize("full_features", [False, True])
def test_cuda_field_kernel_matches_plain(cuda_device, dtype, heads_on, full_features,
                                         record_property):
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff

    # both instantiated widths: (512, 256) and, with full features, (512, 512)
    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,),
                      mapping=True, use_tj_for_s=True, trunk_impl="pallas",
                      fc_use_full_features=full_features)
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
def test_cuda_backward_kernels_match_plain(cuda_device, dtype, heads_on, bwd,
                                           record_property):
    """K1's residuals, K2 and K4 against their plain versions at 4x512 on
    1,001 points, and two runs bit for bit equal (no atomics)."""
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,),
                      mapping=True, use_tj_for_s=True, trunk_impl="pallas",
                      trunk_bwd=bwd)
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


def _trunk_case(cuda_device, n=1001, **cfg_kw):
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec

    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,), mapping=True,
                      trunk_impl="pallas", use_separate_beta_for_s=True, **cfg_kw)
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator().manual_seed(4)
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10).to(cuda_device)
    return cfg, field, fused_field_spec(cfg), enc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emit_acts", [False, True])
def test_cuda_trunk_kernel_matches_plain(cuda_device, dtype, emit_acts, record_property):
    """K3 against its plain version at feat 512 on 1,001 points (ragged
    against the 64-row tile), bitwise repeatable; K6 bitwise repeatable and
    within the same bar of the plain version."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    _, field, spec, enc = _trunk_case(cuda_device)
    with torch.no_grad():
        packed = field.packed(dtype)
        x = ff.pack_x(spec, enc, dtype)
        before = (trunk.FWD_LAUNCHES, trunk.INTERLEAVED_LAUNCHES)
        out, acts = trunk._forward(spec, x, packed, emit_acts)
        again, acts2 = trunk._forward(spec, x, packed, emit_acts)
        il = trunk.fused_trunk_interleaved(spec, x, packed)
        il2 = trunk.fused_trunk_interleaved(spec, x, packed)
        torch.cuda.synchronize()
        assert (trunk.FWD_LAUNCHES, trunk.INTERLEAVED_LAUNCHES) == (before[0] + 2, before[1] + 2)
        ref, ref_acts = trunk.fused_trunk_reference(spec, x, packed, emit_acts)
    assert out.dtype == dtype and out.shape == (x.shape[0], 512)
    # K3 on the tensor cores, K6 on the FMA units: each bitwise repeatable,
    # each within the field bar of the plain version
    assert torch.equal(out, again) and torch.equal(il, il2)
    # chip_smoke.py TOL_FIELD / TOL_RESID say why bf16 has its own bar
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    err = float((out.float() - ref.float()).abs().max())
    record_property("max_abs_err", err)
    assert err < tol
    assert float((il.float() - ref.float()).abs().max()) < tol
    if emit_acts:
        assert acts.shape == (spec.layers, x.shape[0], 512) and torch.equal(acts, acts2)
        assert _rel(acts, ref_acts) < (5e-5 if dtype == torch.float32 else 4e-2)
    else:
        assert acts is None


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["recompute", "stored"])
def test_cuda_fused_trunk_backward_matches_plain(cuda_device, bwd):
    """FusedTrunk (K3 forward, K4 backward) against the plain forward and
    backward on the same inputs, f32."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    _, field, spec, enc = _trunk_case(cuda_device, trunk_bwd=bwd)
    packed = {k: v.clone().requires_grad_(True) for k, v in field.packed(torch.float32).items()}
    x = ff.pack_x(spec, enc, torch.float32).requires_grad_(True)
    cot = torch.randn(x.shape[0], 512, generator=torch.Generator().manual_seed(5))
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
@pytest.mark.parametrize("k,width", [(16, 512), (60, 256), (512, 512), (512, 16), (60, 64)])
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
@pytest.mark.parametrize("k,m", [(16, 256), (60, 512), (512, 512), (512, 16)])
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
    """A pipeline TOML at a width the field kernel is not built for (256
    wide) resolves to the kernels on the card and raises at their launch,
    rather than running the layer-by-layer field."""
    import os

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models import field as fld
    from satnerf_torch.render.renderer import render_rays
    from satnerf_torch.train.state import init_params

    toml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "pipelines", "rs_semantic.toml")
    rcfg = load_render_config(toml, device=cuda_device, fc_units=256)
    assert rcfg.field.trunk_impl == "pallas" and rcfg.field.feat == 256
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
    with pytest.raises(ValueError, match="built for"):
        render_rays(params, rcfg, rays, extras)
    assert fld.PLAIN_CALLS == before


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

    counters = {"k1": (ff, "LAUNCHES"), "k5": (comp, "LAUNCHES"), "k3": (trunk, "FWD_LAUNCHES"),
                "plain_field": (ff, "PLAIN_CALLS"), "plain_trunk": (fld, "PLAIN_CALLS"),
                "plain_k3": (trunk, "FWD_PLAIN_CALLS"), "plain_k5": (comp, "PLAIN_CALLS")}
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
