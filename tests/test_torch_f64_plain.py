"""The plain versions of K1, K2 and K4 in f64: the truth the f32 kernels are
audited against on the card (chip_smoke.py ``trained_audit``'s float64
column, k2_audit.py).

- Given f64 operands, ``fused_field_reference``, ``heads_backward_reference``
  and ``trunk_backward_reference`` compute and return f64.
- Given f32 or bf16 operands they are bitwise what they were when every
  product was cast to f32 (``dot_f32``) and every sine reduced in f32: the
  same functions with those two helpers put back to the explicit f32
  formula give the same bits.
- On a case whose head-bias gradients cancel, the plain f32 heads backward
  lies within TOL_F32_VS_F64 of the f64 one, over each tensor's largest
  element: the plain f32 version is a yardstick whose own error sits well
  below the card's 1e-4 bar (chip_smoke.py TOL_FIELD_BWD["float32"]).

The cancelling case: N points of one image (a seeded 3-layer, 128-wide
rs_semantic field on random points; one sun direction and one embedding, as
on every point of an image; one output gradient per column for every point,
plus a little noise), then the same N points again with the output gradient
times -(1 - EPS), the 2N rows shuffled by a seeded permutation. Each row's
part of a head-bias gradient is linear in that row's output gradient, so
each bias sum becomes EPS times the first half's, while the sum of its
absolute terms grows to (2 - EPS) times the first half's: sum |terms| /
|sum terms| >= (2 - EPS) / EPS = 199 in every element of every head bias and
of b_feats (the test measures it and holds it at >= 100). The shuffle keeps
the partial sums of the plain version's f32 sums as small as a trained
batch keeps them; in row order, or with every pair of rows side by side,
the first half's sum is built up before the second half takes it away again.

Bars: TOL_F32_VS_F64 1e-5 (measured here: at most 1.5e-6 on the biases and
4.5e-6 on any gradient, on the CPU); the bitwise checks are exact. About 5 s
alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from satnerf_torch.core.encoding import positional_encoding
from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
from satnerf_torch.ops import fastmath, trunk
from satnerf_torch.ops import field_fused as ff

torch.set_num_threads(2)

EPS = 0.01
N = 2048
TOL_F32_VS_F64 = 1e-5
MIN_CANCELLATION = 100.0


def _case(n: int = N, seed: int = 0):
    """(spec, {dtype: (x, aux, packed)}, g_out f32) of a seeded field."""
    cfg = FieldConfig(variant="rs_semantic", layers=3, feat=128, skips=(1,), mapping=True,
                      use_tj_for_s=True, trunk_impl="pallas")
    field = Field(cfg, generator=torch.Generator().manual_seed(seed))
    spec = fused_field_spec(cfg)
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    # the sun direction and the image's embedding are the same on every point
    # of one image, as in a training batch
    sun = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(1, 3)).astype(np.float32)), dim=1).expand(n, 3)
    te = torch.from_numpy(rng.normal(size=(1, cfg.t_embedding_tau)).astype(np.float32))
    te = te.expand(n, -1)
    # one gradient per column for every point, and a little noise: the first
    # half's sums do not cancel by themselves
    g_out = rng.normal(size=(1, spec.out_w)) + 0.1 * rng.normal(size=(n, spec.out_w))
    g_out = torch.from_numpy(g_out.astype(np.float32))
    enc = positional_encoding(xyz, cfg.mapping_pos_n_freq)
    inputs = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16, torch.float64):
            inputs[dt] = (ff.pack_x(spec, enc, dt), ff.pack_aux(spec, sun, te, None, dt),
                          ff.pack_field(field, spec, dt))
    return spec, inputs, g_out


def _outputs(spec, x, aux, packed, g_out) -> list:
    """Every output of the three plain versions on one set of operands."""
    out, shared, _ = ff._reference_forward(spec, x, aux, packed, resid=True)
    g_shared, g_aux, g_heads = ff.heads_backward_reference(spec, shared, aux, g_out, packed)
    g_trunk = trunk.trunk_backward_reference(spec, x, packed, None, g_shared)
    stored = dataclasses.replace(spec, trunk_bwd="stored")
    _, _, acts = ff._reference_forward(stored, x, aux, packed, resid=True)
    g_stored = trunk.trunk_backward_reference(stored, x, packed, acts, g_shared)
    return [out, shared, g_shared, g_aux, *g_heads.values(), *g_trunk, *g_stored]


def test_f64_operands_give_f64_results():
    spec, inputs, g_out = _case(n=64)
    x, aux, packed = inputs[torch.float64]
    assert ff.fused_field_reference(spec, x, aux, packed).dtype == torch.float64
    outs = _outputs(spec, x, aux, packed, g_out.double())
    assert all(t.dtype == torch.float64 for t in outs), [t.dtype for t in outs]
    assert fastmath.acc_dtype(torch.float64) == torch.float64
    assert trunk.dot_f32(x, packed["w0"]).dtype == torch.float64
    # the f64 sine engines are the same polynomials, evaluated in f64
    a = torch.linspace(-40.0, 40.0, 1001, dtype=torch.float64)
    for name in fastmath.SIN_MODES:
        s64 = fastmath.SINE_ENGINES[name](a)
        c64 = fastmath.COSINE_ENGINES[name](a)
        assert s64.dtype == c64.dtype == torch.float64
        assert float((s64 - fastmath.SINE_ENGINES[name](a.float()).double()).abs().max()) < 1e-5
        assert float((c64 - fastmath.COSINE_ENGINES[name](a.float()).double()).abs().max()) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_and_bf16_results_are_bitwise_the_explicit_f32_formula(monkeypatch, dtype):
    spec, inputs, g_out = _case(n=256)
    x, aux, packed = inputs[dtype]
    got = _outputs(spec, x, aux, packed, g_out)

    def dot_cast_f32(a, w):  # each operand cast to f32, as before f64 was taken
        return a.to(torch.float32) @ w.to(torch.float32)

    monkeypatch.setattr(trunk, "dot_f32", dot_cast_f32)
    monkeypatch.setattr(ff, "dot_f32", dot_cast_f32)
    for module in (fastmath, trunk, ff):  # every sum and sine in f32
        monkeypatch.setattr(module, "acc_dtype", lambda dt: torch.float32)
    want = _outputs(spec, x, aux, packed, g_out)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


def test_plain_f32_heads_backward_holds_f64_where_the_bias_sums_cancel():
    spec, inputs, g_out = _case()
    perm = torch.from_numpy(np.random.default_rng(1).permutation(2 * N))
    g2 = torch.cat([g_out, -(1.0 - EPS) * g_out])[perm]
    ops = {}
    for dt in (torch.float32, torch.float64):
        x, aux, packed = inputs[dt]
        x2, aux2 = torch.cat([x, x])[perm], torch.cat([aux, aux])[perm]
        _, shared, _ = ff._reference_forward(spec, x2, aux2, packed, resid=True)
        ops[dt] = (shared, aux2, g2.to(dt), packed)
    trace = {}
    truth = ff.heads_backward_reference(spec, *ops[torch.float64], trace=trace)
    got = ff.heads_backward_reference(spec, *ops[torch.float32])

    # the construction: every element of every head bias cancels 100-fold or
    # more (sky0's ReLU units that never fire have no terms at all)
    for name, ga in [*trace["ga"].items(), ("b_feats", trace["g_feats"])]:
        terms = ga.abs().sum(0)
        ratio = terms[terms > 0] / ga.sum(0).abs()[terms > 0]
        assert float(ratio.min()) >= MIN_CANCELLATION, name

    def rel(a, b):
        return float((a.detach().double() - b).abs().max() / b.abs().max())

    errs = {"g_shared": rel(got[0], truth[0]), "g_aux": rel(got[1], truth[1])}
    errs.update({k: rel(got[2][k], v) for k, v in truth[2].items()})
    for i, name in enumerate(ff.HIDDEN_BIAS_ROWS):
        if name in trace["ga"]:
            errs[f"b_heads.{name}"] = rel(got[2]["b_heads"][i], truth[2]["b_heads"][i])
    assert max(errs.values()) <= TOL_F32_VS_F64, errs
