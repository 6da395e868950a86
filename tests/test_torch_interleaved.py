"""K6, the interleaved trunk (``ops/trunk.py:fused_trunk_interleaved``,
``csrc/trunk_ws.cuh``), against the JAX prototype it replaces,
``tools/interleave_trunk_proto.py:fused_trunk_il``, run in Pallas interpret
mode on the CPU (loaded by path: ``tools/`` is no package; its module-level
``spec`` is set to the case's trunk for the call).

- The port's K6 path on the CPU (its plain version) against the prototype
  on the same weights (carried over by ``field_pair``), ragged n: f32
  within 5e-5 (tests/test_pallas_trunk.py:61), bf16 within 0.1 (:78).
- The kernel's arithmetic emulated in torch on the weights the wrapper
  prepares (``tc_trunk_weights``, in f32 split into tf32 hi + lo by
  ``tc_split_weights``): each warpgroup's 128 columns of a pass, in the
  ping-pong order (layer i: warpgroup 0 pass 0, warpgroup 1 pass 0, then
  pass 1), a fresh sum per 16 columns of K (f32: two tf32 k-steps, the
  cross terms lo*hi + hi*lo of both, then hi*hi of both; bf16: one k-step)
  added into an f32 total, then
  bias, sine and the store in the compute dtype. Held against the prototype
  at the bars above, and bitwise against K3's order (both warpgroups' 256
  columns of a pass at once), which K6 keeps.
- The wrapper raises for what the kernel does not take, and the lockstep
  copy of ``k6_ablation.py`` still patches the kernel's source.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from satnerf_tpu.models import field as jfield
from satnerf_tpu.ops.pallas import trunk as jtrunk
from satnerf_torch.models import field as tfield
from satnerf_torch.ops import _bwd, trunk
from satnerf_torch.ops import field_fused as tff
from satnerf_torch.ops.fastmath import SINE_ENGINES
from test_torch_field_tc import tc_layout_inverse
from torch_parity import field_inputs, field_pair, max_err

torch.set_num_threads(2)

PROTO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "interleave_trunk_proto.py")
CASE = dict(variant="rs_semantic", layers=3, feat=512, skips=(2,), mapping=True,
            trunk_impl="pallas")
TOL = {"f32": 5e-5, "bf16": 0.1}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
K6_ORDER = ((0, 0), (0, 1), (1, 0), (1, 1))  # (pass, warpgroup) in the tensor cores' order
K3_ORDER = ((0, None), (1, None))  # a pass's 256 columns, both warpgroups at once


def _proto():
    spec = importlib.util.spec_from_file_location("interleave_trunk_proto", PROTO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CASES: dict = {}


def _case(n: int, dtype: str):
    """(prototype output (n, F) f32, port spec, x, packed) on one trunk's
    weights; the prototype in interpret mode."""
    key = (n, dtype)
    if key not in _CASES:
        jcfg, params, tcfg, module = field_pair(**CASE)
        tdt, jdt = DTYPES[dtype]
        jspec = jtrunk.TrunkSpec(layers=jcfg.layers, feat=jcfg.feat, skips=tuple(jcfg.skips),
                                 c_in=jcfg.xyz_in)
        xyz = field_inputs(n)[0]
        enc = jfield.positional_encoding(jnp.asarray(xyz), jcfg.mapping_pos_n_freq)
        proto = _proto()
        proto.spec = jspec
        with pltpu.force_tpu_interpret_mode():
            ref = proto.fused_trunk_il(enc.astype(jdt), jtrunk.pack_trunk(params["trunk"],
                                                                          jspec, jdt))
        spec = tfield.fused_field_spec(tcfg)
        with torch.no_grad():
            x = tff.pack_x(spec, torch.from_numpy(np.array(enc)), tdt)
            packed = trunk.pack_trunk(module, spec, tdt)
        _CASES[key] = (np.asarray(ref.astype(jnp.float32)), spec, x, packed)
    return _CASES[key]


# -- the emulation -----------------------------------------------------------------


def _group(a, wh, wl):
    """One fresh sum of 16 columns of K: f32 as two tf32 k-steps, the cross
    terms lo*hi and hi*lo of both first, then hi*hi of both (the weights'
    parts as the wrapper split them); bf16 as one k-step; f32 sums."""
    if wl is None:
        return a.float() @ wh.float().t()
    steps = (slice(0, 8), slice(8, 16))
    ah, al = _bwd.split_tf32(a)
    terms = [t for k in steps for t in (al[:, k] @ wh[:, k].t(), ah[:, k] @ wl[:, k].t())]
    terms += [ah[:, k] @ wh[:, k].t() for k in steps]
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def emulate(spec, x, prepared, order):
    """h_{L-1} as the kernel computes it from ``prepared``
    (``tc_split_weights``), its column blocks in ``order``."""
    dt = x.dtype
    F, sin = spec.feat, SINE_ENGINES[spec.sin_mode]
    kx = _bwd.padded_k(spec.cx)

    def wt(key):  # W^T (..., F, K padded) of a prepared weight, and its lo part
        t = prepared[key]
        k = t.shape[-3] * t.shape[-1]
        lo = prepared.get(f"{key}_lo")
        return tc_layout_inverse(t, k), None if lo is None else tc_layout_inverse(lo, k)

    w0, w_mid, w_skip = wt("w0"), wt("w_mid"), wt("w_skip")
    xp = _bwd.pad_cols(x, kx)
    h, s = None, 0
    for i in range(spec.layers):
        if i == 0:
            prods = [(xp, *w0)]
        else:
            prods = [(h, w_mid[0][i - 1], None if w_mid[1] is None else w_mid[1][i - 1])]
            if i in spec.skips:
                prods.append((xp, w_skip[0][s], None if w_skip[1] is None else w_skip[1][s]))
                s += 1
        out = torch.empty((x.shape[0], F), dtype=dt)
        for p, g in order:
            cols = (slice(256 * p + 128 * g, 256 * p + 128 * (g + 1)) if g is not None
                    else slice(256 * p, 256 * (p + 1)))
            total = torch.zeros((x.shape[0], cols.stop - cols.start))
            for a, wh, wl in prods:
                for k0 in range(0, a.shape[1], 16):
                    k = slice(k0, k0 + 16)
                    total = total + _group(a[:, k], wh[cols, k],
                                           None if wl is None else wl[cols, k])
            v = total + prepared["b"][i, cols]
            out[:, cols] = sin((spec.w0 if i == 0 else 1.0) * v).to(dt)
        h = out
    return h


# -- the tests ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 65, 300])
def test_port_k6_matches_the_prototype(n, dtype):
    ref, spec, x, packed = _case(n, dtype)
    plain, launches = trunk.FWD_PLAIN_CALLS, trunk.INTERLEAVED_LAUNCHES
    with torch.no_grad():
        out = trunk.fused_trunk_interleaved(spec, x, packed)
    assert (trunk.FWD_PLAIN_CALLS, trunk.INTERLEAVED_LAUNCHES) == (plain + 1, launches)
    assert out.dtype == x.dtype and out.shape == (n, spec.feat)
    assert max_err(out, ref[:, : spec.feat]) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_k6_matches_the_prototype_and_k3(dtype):
    ref, spec, x, packed = _case(65, dtype)
    with torch.no_grad():
        prepared = trunk.tc_split_weights(trunk.tc_trunk_weights(packed))
        k6 = emulate(spec, x, prepared, K6_ORDER)
        k3 = emulate(spec, x, prepared, K3_ORDER)
    assert torch.equal(k6, k3)
    assert max_err(k6, ref[:, : spec.feat]) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_weights_are_the_kernels_split(dtype):
    """In f32 each prepared weight becomes its tf32 hi (under its key) and
    lo (``<key>_lo``), exactly ``split_tf32`` (K3's split of every chunk),
    hi + lo within 2^-21 of the weight; bf16 weights pass through."""
    _, spec, x, packed = _case(65, "f32" if dtype == torch.float32 else "bf16")
    prepared = trunk.tc_trunk_weights(packed)
    split = trunk.tc_split_weights(prepared)
    if dtype == torch.bfloat16:
        assert split is prepared
        return
    assert set(split) == set(prepared) | {f"{k}_lo" for k in trunk.TC_SPLIT_KEYS}
    for k in trunk.TC_SPLIT_KEYS:
        hi, lo = _bwd.split_tf32(prepared[k])
        assert torch.equal(split[k], hi) and torch.equal(split[f"{k}_lo"], lo)
        assert torch.equal(_bwd.tf32_round(split[k]), split[k])
        err = (split[k].double() + split[f"{k}_lo"].double() - prepared[k].double()).abs()
        assert float(err.max()) <= 2.0 ** -21 * float(prepared[k].abs().max())
    assert split["b"] is prepared["b"]


def test_wrapper_raises_for_what_the_kernel_does_not_take():
    _, spec, x, packed = _case(65, "f32")
    cases = [
        (dataclasses.replace(spec, feat=256), x, {}, "feat"),
        (dataclasses.replace(spec, c_in=100), torch.zeros(4, 100), {}, "inputs"),
        (spec, x, {"emit_acts": True}, "emit_acts"),
        (spec, torch.empty(4, spec.cx, device="meta"), {}, "device"),
    ]
    for sp, xx, kw, what in cases:
        with pytest.raises(ValueError, match=what):
            trunk.fused_trunk_interleaved(sp, xx, packed, **kw)


def test_ablation_patch_applies():
    """``k6_ablation.py`` builds a lockstep copy of K6 by editing exact lines
    of csrc/trunk_ws.cuh: each is still there once, and the copy keeps no
    turn barrier and interleaves the stream by warpgroup."""
    import k6_ablation
    from satnerf_torch.ops import _build

    src = k6_ablation.lockstep_source(_build.CSRC)
    assert "bar_sync(mine)" not in src and "bar_arrive(theirs)" not in src
    assert "mma_phase<T>(q + g," in src and "pg < 2" in src
