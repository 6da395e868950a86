"""The arithmetic of the tensor-core forward kernels K1 and K3
(csrc/field_fused.cu, csrc/trunk_tc.cuh), emulated in torch on the CPU.

The emulation runs the kernels' dataflow on the weights the wrapper
prepares (``ops/field_fused.py:tc_weights``): every product as 3xTF32 in f32
(both operands split in the kernel into tf32 hi + lo with the rounding of
``ops/_bwd.py:split_tf32``, then lo*hi + hi*lo + hi*hi) or bf16 operands
with f32 sums, K padded with zeros
to a multiple of 16, the heads projected from the activations in the order
the accumulator feeds the register A fragment (the permuted K of the
prepared projections), each warpgroup's half of the columns summed apart and
the two halves added last. It is held against the JAX package's fused field
kernel in interpret mode at flagship widths (8x512, skip at 4, 60 inputs,
256- or 512-wide heads): 5e-5 in f32 (tests/test_pallas_trunk.py:61), 0.1 in
bf16 (:78). The preparation itself is checked exactly against the packed
weights.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satnerf_tpu.models import field as jfield
from satnerf_tpu.ops.pallas import field_fused as jff
from satnerf_tpu.ops.pallas.trunk import TrunkSpec, pack_trunk
from satnerf_torch.models import field as tfield
from satnerf_torch.ops import _bwd, trunk
from satnerf_torch.ops import field_fused as tff
from satnerf_torch.ops.fastmath import SINE_ENGINES
from torch_parity import field_inputs, field_pair, max_err

torch.set_num_threads(2)

FLAGSHIP = dict(variant="rs_semantic", layers=8, feat=512, skips=(4,), mapping=True,
                use_tj_for_s=True, trunk_impl="pallas")
N_POINTS = 200


# -- the emulation -----------------------------------------------------------------


def tc_layout_inverse(t: torch.Tensor, k: int) -> torch.Tensor:
    """W^T (..., N, k) back from ``ops/trunk.py:tc_operand``'s layout (the
    padding of K dropped)."""
    *lead, p, s, rows, ks = t.shape
    x = t.reshape(*lead, p, s, rows, 2, ks // 2)
    swap = ((torch.arange(rows, device=t.device) >> 2) & 1).bool()
    x = torch.where(swap.view(rows, 1, 1), x.flip(-2), x)
    return x.transpose(-4, -3).reshape(*lead, p * rows, s * ks)[..., :k]


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (N, K) against w = W^T (rows, Kp): the kernel's product a @ W, K
    padded with zeros."""
    a = _bwd.pad_cols(a, w.shape[-1])
    if w.dtype == torch.float32:
        ah, al = _bwd.split_tf32(a)
        wh, wl = _bwd.split_tf32(w)
        return al @ wh.t() + ah @ wl.t() + ah @ wh.t()
    return a.float() @ w.float().t()


def _feed(h: torch.Tensor) -> torch.Tensor:
    """The projection's A as the accumulator feeds it: in f32 position p of
    each group of 8 holds column PROJ_PERM[p]."""
    if h.dtype != torch.float32:
        return h
    idx = torch.arange(h.shape[1]).view(-1, 8)[:, list(tff.PROJ_PERM)].reshape(-1)
    return h[:, idx]


def _unprepare(prepared: dict) -> dict:
    """The prepared weights back as W^T (..., N, K padded), through the
    inverse of the kernels' tile layout; biases as they are."""
    out = {}
    for k, t in prepared.items():
        if k.startswith("b"):
            out[k] = t
        else:
            out[k] = tc_layout_inverse(t, t.shape[-3] * t.shape[-1])
    return out


def emulate_field(spec, x, aux, prepared, resid: bool = False):
    """(out (N, 16) f32, h_{L-1}, (L, N, F) pre-activations) as K1 computes
    them from the prepared weights."""
    dt, p = x.dtype, _unprepare(prepared)
    sin = SINE_ENGINES[spec.sin_mode]
    F, fl = spec.feat, spec.fl
    parts = [torch.zeros(x.shape[0], spec.out_w), torch.zeros(x.shape[0], spec.out_w)]

    def project(h, w2):  # each warpgroup's half of the columns, summed apart
        half = h.shape[1] // 2
        fed = _feed(h)
        for g in range(2):
            cols = slice(g * half, (g + 1) * half)
            parts[g] = parts[g] + _mm(fed[:, cols], w2[:, cols])

    def hb(name):
        return p["b_heads"][tff.HIDDEN_BIAS_ROWS.index(name)]

    acts, h, s = [], None, 0
    for i in range(spec.layers):
        if i == 0:
            a = _mm(x, p["w0"])
        else:
            a = _mm(h, p["w_mid"][i - 1])
            if i in spec.skips:
                a = a + _mm(x, p["w_skip"][s])
                s += 1
        a = a + p["b"][i]
        acts.append(a.to(dt))
        h = sin((spec.w0 if i == 0 else 1.0) * a).to(dt)
    shared = h
    project(h, p["w2_shared"])
    feats = (_mm(h, p["w_feats"]) + p["b_feats"]).to(dt)

    def hidden(prods, bias, relu=False):
        a = sum(_mm(t, w) for t, w in prods) + bias
        return (torch.clamp(a, min=0.0) if relu else sin(a)).to(dt)

    if spec.heads_on:
        project(hidden([(feats, p["w_rgb0"])], hb("rgb0")), p["w2_rgb"])
        project(hidden([(aux, p["w_sky0_aux"])], hb("sky0"), relu=True), p["w2_sky"])
        if spec.has_beta:
            project(hidden([(feats, p["w_b0_f"]), (aux, p["w_b0_aux"])], hb("b0")),
                    p["w2_beta"])
        if spec.has_semantic:
            prods = [(feats, p["w_s0_f"])]
            if spec.use_tj_for_s:
                prods.append((aux, p["w_s0_aux"]))
            project(hidden(prods, hb("s0")), p["w2_sem"])
    sv = hidden([(feats, p["w_sv0_f"]), (aux, p["w_sv0_aux"])], hb("sv0"))
    sv = hidden([(sv, p["w_sv1"])], hb("sv1"))
    sv = hidden([(sv, p["w_sv2"])], hb("sv2"))
    project(sv, p["w2_sv"])
    out = parts[0] + parts[1] + p["b_small" if spec.heads_on else "b_small_sc"]
    return out, shared, torch.stack(acts)


# -- against the JAX kernel ----------------------------------------------------------


def _case(dtype: str, heads_on: bool, full: bool, n: int = N_POINTS, **cfg):
    """(JAX raw columns, emulated raw columns, the torch case) at flagship
    widths; ``full``: 512-wide heads (fc_use_full_features); ``cfg``: other
    FieldConfig keys (mapping_pos_n_freq, t_embedding_tau, n_classes)."""
    jcfg, params, tcfg, module = field_pair(**FLAGSHIP, fc_use_full_features=full, **cfg)
    xyz, sun, _, te, _ = field_inputs(n, tau=jcfg.t_embedding_tau)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tspec = TrunkSpec(layers=jcfg.layers, feat=jcfg.feat, skips=tuple(jcfg.skips),
                      c_in=jcfg.xyz_in)
    jspec = jff.FieldSpec(trunk=tspec, fl=jcfg.feat_last, tau=jcfg.t_embedding_tau,
                          n_classes=jcfg.n_classes, has_beta=True, has_semantic=True,
                          use_tj_for_s=True, sep_t_s=False, heads_on=heads_on)
    enc = jfield.positional_encoding(jnp.asarray(xyz), jcfg.mapping_pos_n_freq)
    raw_j = np.asarray(jff.fused_field(
        jspec, True, enc.astype(jdt),
        jff.pack_aux(jspec, jnp.asarray(sun), jnp.asarray(te), None, jdt),
        pack_trunk(params["trunk"], tspec, jdt), jff.pack_heads(params, jspec, jdt)))

    spec = dataclasses.replace(tfield.fused_field_spec(tcfg), heads_on=heads_on)
    x = tff.pack_x(spec, torch.from_numpy(np.array(enc)), tdt)
    aux = tff.pack_aux(spec, torch.from_numpy(sun), torch.from_numpy(te), None, tdt)
    with torch.no_grad():
        packed = module.packed(tdt)
        out, shared, acts = emulate_field(spec, x, aux, tff.tc_weights(packed))
    return raw_j[:, : spec.out_w], out, (spec, x, aux, packed, shared, acts)


@pytest.mark.parametrize("dtype,heads_on,full", [
    ("f32", True, False), ("f32", False, False), ("f32", True, True), ("bf16", True, False),
])
def test_emulated_kernel_matches_jax_kernel(dtype, heads_on, full):
    raw_j, out, (spec, x, aux, packed, shared, acts) = _case(dtype, heads_on, full)
    tol = 5e-5 if dtype == "f32" else 0.1
    assert max_err(out, raw_j) < tol
    # and the port's plain version on the same inputs, residuals included
    ref, ref_shared, ref_acts = tff._reference_forward(
        dataclasses.replace(spec, trunk_bwd="stored"), x, aux, packed, True)
    assert max_err(out, ref.numpy()) < tol
    if dtype == "f32":
        assert max_err(shared, ref_shared.numpy()) < 5e-5
        assert max_err(acts, ref_acts.numpy()) < 5e-5 * max(1.0, float(ref_acts.abs().max()))
    if not heads_on:  # only sigma and sun_v are evaluated
        dead = [c for c in range(spec.out_w) if c not in (tff.COL_SIGMA, tff.COL_SUN)]
        assert torch.all(out[:, dead] == 0)


def test_emulated_trunk_matches_jax_trunk_kernel():
    """K3's arithmetic (the trunk of the emulation) against the JAX trunk
    kernel in interpret mode, f32, flagship widths."""
    from satnerf_tpu.ops.pallas.trunk import fused_trunk as jfused_trunk

    jcfg, params, tcfg, module = field_pair(**FLAGSHIP)
    xyz = field_inputs(N_POINTS)[0]
    tspec = TrunkSpec(layers=jcfg.layers, feat=jcfg.feat, skips=tuple(jcfg.skips),
                      c_in=jcfg.xyz_in)
    enc = jfield.positional_encoding(jnp.asarray(xyz), jcfg.mapping_pos_n_freq)
    ref = np.asarray(jfused_trunk(tspec, True, enc, pack_trunk(params["trunk"], tspec,
                                                                jnp.float32)))
    spec = tfield.fused_field_spec(tcfg)
    x = tff.pack_x(spec, torch.from_numpy(np.array(enc)), torch.float32)
    with torch.no_grad():
        packed = module.packed(torch.float32)
        _, shared, _ = emulate_field(spec, x, tff.pack_aux(
            spec, torch.zeros(N_POINTS, 3), None, None, torch.float32), tff.tc_weights(packed))
    assert max_err(shared, ref[:, : spec.feat]) < 5e-5


# -- the wrapper's preparation, exactly ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_weights_are_the_packed_ones(dtype):
    """Every prepared tensor is W^T of its packed block with K zero-padded to
    a multiple of 16, in f32 the projections' K permuted by PROJ_PERM within
    each group of 8; biases untouched. Element (n, k) sits where the kernel
    reads it: pass n // rows, k-step k // ks, row r = n % rows, 16-byte half
    (k % ks) // (ks / 2) XOR (r / 4) % 2 (csrc/trunk_tc.cuh, desc_sw32)."""
    _, _, tcfg, module = field_pair(**dict(FLAGSHIP, layers=3, skips=(1,)))
    with torch.no_grad():
        packed = module.packed(dtype)
        prep = tff.tc_weights(packed)
    assert set(prep) == set(packed)
    f32 = dtype == torch.float32
    ks = 32 // torch.tensor([], dtype=dtype).element_size()
    rng = np.random.default_rng(5)
    for k, w in packed.items():
        got = prep[k]
        if k.startswith("b"):
            assert got is w
            continue
        wt = w.transpose(-1, -2)
        if k.startswith("w2_") and f32:
            perm = torch.tensor(tff.PROJ_PERM)
            wt = wt[:, (torch.arange(wt.shape[-1]).view(-1, 8)[:, perm]).reshape(-1)]
        rows = 16 if k.startswith("w2_") else trunk.TC_PASS_ROWS
        kp = _bwd.padded_k(wt.shape[-1])
        assert got.shape == (*wt.shape[:-2], wt.shape[-2] // rows, kp // ks, rows, ks), k
        assert got.is_contiguous() and got.dtype == dtype
        full = _bwd.pad_cols(wt, kp)
        assert torch.equal(tc_layout_inverse(got, kp), full), k
        flat = got.reshape(*wt.shape[:-2], -1)
        for n, kk in zip(rng.integers(0, wt.shape[-2], 64), rng.integers(0, kp, 64)):
            pas, r = divmod(int(n), rows)
            s_, e = divmod(int(kk), ks)
            half, e2 = divmod(e, ks // 2)
            at = ((pas * (kp // ks) + s_) * rows + r) * ks + (half ^ ((r >> 2) & 1)) * (ks // 2) + e2
            assert torch.equal(flat[..., at], full[..., n, kk]), k


def test_projection_feed_order_inverts_the_permutation():
    """The accumulator's feed order and the projection's permuted K meet:
    fed activations against the prepared projection give h @ W2 exactly as
    the unpermuted product does (tf32-exact operands)."""
    rng = np.random.default_rng(3)
    h = _bwd.tf32_round(torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32)))
    w2 = _bwd.tf32_round(torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32)))
    prep = tc_layout_inverse(tff.tc_projection(w2), 256)
    got = _feed(h).double() @ prep.double().t()
    assert torch.allclose(got, h.double() @ w2.double(), rtol=0, atol=1e-9)


def test_prepared_weights_are_cached_until_the_packed_ones_change():
    """The dicts of ``Field.packed`` keep their preparation until a changed
    parameter gives a new dict; any other dict, which may be changed in
    place (inference tensors keep no version to show it), is prepared on
    every call."""
    _, _, _, module = field_pair(**dict(FLAGSHIP, layers=2, skips=()))
    calls = []

    def maker(p):
        def make():
            calls.append(1)
            return trunk.tc_trunk_weights(p)
        return make

    own = module.packed(torch.float32)
    assert isinstance(own, trunk.PackedWeights) and module.packed(torch.float32) is own
    a = trunk.tc_cached("test", own, maker(own))
    assert trunk.tc_cached("test", own, maker(own)) is a and len(calls) == 1
    with torch.no_grad():
        module.fc_net[0].weight.add_(1.0)  # a changed parameter: a new dict
    new = module.packed(torch.float32)
    assert new is not own
    b = trunk.tc_cached("test", new, maker(new))
    assert len(calls) == 2 and not torch.equal(b["w0"], a["w0"])
    plain = dict(new)
    trunk.tc_cached("test", plain, maker(plain))
    trunk.tc_cached("test", plain, maker(plain))
    assert len(calls) == 4
    with torch.inference_mode():
        inf = {k: v.clone() for k, v in new.items()}
        first = trunk.tc_cached("test", inf, maker(inf))
        inf["w0"].mul_(0.5)  # in place, no version counter
        again = trunk.tc_cached("test", inf, maker(inf))
    assert len(calls) == 6 and torch.equal(again["w0"], first["w0"] * 0.5)


def test_shared_packing_packs_each_field_once_per_block():
    """Inside ``shared_packing`` every differentiable packing of one field is
    one dict while its parameters are unchanged, and gradients through the
    shared dict equal those through separate packings."""
    _, _, cfg, module = field_pair(**dict(FLAGSHIP, layers=2, skips=()))
    spec = tfield.fused_field_spec(cfg)
    assert tfield._packed_for_call(module, spec, torch.float32) is not \
        tfield._packed_for_call(module, spec, torch.float32)
    grads = []
    for shared in (False, True):
        module.zero_grad()
        block = tfield.shared_packing() if shared else torch.enable_grad()
        with block:
            packs = [tfield._packed_for_call(module, spec, torch.float32) for _ in range(3)]
            assert (packs[0] is packs[2]) == shared
            loss = sum((p["w0"] * (i + 1)).sum() + p["b"].square().sum()
                       for i, p in enumerate(packs))
            loss.backward()
        grads.append([p.grad.clone() for p in module.parameters() if p.grad is not None])
    assert len(grads[0]) == len(grads[1]) > 0
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-6, atol=0)
    with tfield.shared_packing():
        first = tfield._packed_for_call(module, spec, torch.float32)
        with torch.no_grad():
            module.fc_net[0].bias.add_(1.0)  # a changed parameter: a new packing
        assert tfield._packed_for_call(module, spec, torch.float32) is not first
