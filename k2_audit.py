#!/usr/bin/env python3
"""Where K2's f32 head gradients lose accuracy at trained weights: every
intermediate of K2 and of its f32 plain version against the plain version
in f64, and each of K2's sums alone at the trained operands, on one card.

    python3 k2_audit.py [--out FILE]

Two trained states, both 512 wide in bf16 on ``generate_scene`` scenes:

- ``card_test``: the state of ``tests/test_torch_cuda.py::
  test_cuda_kernels_match_plain_at_trained_weights`` (2 x 512, 100 steps,
  2 + 1 views of 32², car-reg from step 3), audited on 512 + 512 rays;
- ``quality``: ``chip_smoke.py``'s ``quality_tools`` field (8 x 512, 64
  samples, 300 steps of 1,024 rays on QUALITY_SCENE), on 1,024 + 1,024.

At each state one f32 training step through the kernels on
``chip_smoke.trained_audit``'s batch records the inputs of every K2 call
(the step's three: the main and depth renders' heads, the solar-correction
points' sigma + sun variant). Errors are max |x - truth| / max |truth|.

- ``gradients``: each head gradient of K2 (``ops/field_fused.py:
  _heads_backward_cuda``) and of ``heads_backward_reference`` in f32 (TF32
  off) against ``heads_backward_reference`` in f64 on the same inputs, in
  the worst call and summed over the step's calls (the parameter's
  gradient); beside them, to part K2's two stages, K2's own workspaces
  summed exactly (``kernel_rows``: the row GEMM's error alone) and the f64
  workspaces rounded to f32 summed by K2's reduction (``kernel_sums``) and
  by torch in f32 (``plain_sums``).
- ``stages``: each sum of K2 alone on the f64 workspaces rounded to f32,
  against the same sum in f64, beside torch's f32 product or sum: (a) the
  row GEMM (``_bwd.row_op``, no epilogue) of every recompute and
  reverse-sweep product and of g_feats; (b) the reduction's dW; (c) its
  bias sums, folded into a GEMM's pass as f32 has them (``fold``) and apart
  (``sum_tile``, bf16's route).
- ``upstream``: the step's parameter gradients against the plain step in
  f64 with each kernel in turn replaced by its plain version (f32, TF32
  off; ``UPSTREAM``), and K1's plain version on 3xTF32's view of its weights
  (``k1_w22``) or with every product as 3xTF32 summed in f32 (``k1_3xtf32``):
  which kernel carries what is left, and whether the operands' split does.
- ``trained_audit``: ``chip_smoke.trained_audit`` at the state, its worst
  errors per group and its float64 column.

``probe``: s (1 + c 2^-24) through the row GEMM (one row of K 32 into
width 64, f32 and bf16), the two terms in one k-step or in two, beside the
exact sum's roundings to nearest, toward zero and down: the tensor cores
truncate toward zero.

Writes the JSON to FILE (default ``build/k2_audit.json``) and prints
a summary. It needs one card and exits with 2 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CARD_TEST_RAYS = 512


def card_test_state(work: str):
    """(pipeline, params, step) of the card test's trained field."""
    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    datasets = os.path.join(work, "datasets")
    generate_scene(os.path.join(datasets, "SYN"), n_train=2, n_test=1, img_size=32,
                   n_tie_points=300)
    run = RunConfig(dataset_name="SYN", datasets_dp=datasets,
                    cache_dp=os.path.join(work, "cache"),
                    workspace_dp=os.path.join(work, "training"), max_train_steps=100,
                    check_val_every_n_epoch=1000, num_sanity_val_steps=0, seed=0)
    pipe = RSSemanticConfig(n_samples=32, fc_layers=2, fc_units=512, fc_skips=[1],
                            batch_size=512, ignore_car_index=False, use_car_reg_loss=True,
                            car_reg_loss_start=3, lambda_c=1.0, compute_dtype="bfloat16")
    pipeline = load_pipeline(MainConfig(run, pipe))
    pipeline.prepare_run()
    pipeline.load_datasets()
    state = Trainer(pipeline, device="cuda").fit(validate_every_epoch=False)
    return pipeline, state.params, state.step


def quality_state(smoke, work: str):
    """(pipeline, params, step) of chip_smoke's quality_tools field."""
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.tools import ours_train_eval

    scene = os.path.join(work, "datasets", "SYN_Q")
    generate_scene(scene, **smoke.QUALITY_SCENE)
    try:
        with smoke.recording_fit() as fits:
            rc = ours_train_eval.main([
                scene, os.path.join(work, "quality"), "--steps", str(smoke.QUALITY_STEPS),
                "--batch", str(smoke.TRAIN_RAYS), "--n-samples", "64", "--units", "512",
                "--dtype", "bfloat16", "--device", "cuda"])
    finally:
        disable_tf32()
    smoke.check(rc == 0 and len(fits) == 1, f"ours_train_eval exited {rc}")
    trainer, state = fits[0]
    return trainer.pipeline, state.params, state.step


def k2_inputs(smoke, pipeline, params, step, n_rays: int, dev) -> list:
    """The inputs of every K2 call of one f32 kernel step at ``params``."""
    from satnerf_torch.ops import field_fused as ff

    calls = []
    heads_backward = ff.heads_backward

    def recorded(spec, shared, aux, g_out, packed, need_aux=True):
        calls.append((spec, shared.detach().clone(), aux.detach().clone(),
                      g_out.detach().clone(),
                      {k: v.detach().clone() for k, v in packed.items()}))
        return heads_backward(spec, shared, aux, g_out, packed, need_aux)

    batch = smoke.audit_batch(pipeline, n_rays, n_rays, smoke.AUDIT_SEED, dev)
    ff.heads_backward = recorded
    try:
        smoke.audit_engine(pipeline, params, step, batch, dev, "float32", plain=False)
    finally:
        ff.heads_backward = heads_backward
    return calls


def full_f32() -> None:
    """Library f32 matmuls in full f32 (a kernel step sets the run's
    precision, which may allow TF32)."""
    import torch

    from satnerf_torch.device import disable_tf32

    torch.set_float32_matmul_precision("highest")
    disable_tf32()


def _grads(spec, shared, aux, g, ws, reduce) -> dict:
    """{gradient name: tensor} of K2's reduction on the workspaces ``ws``
    (feats, hid, ga, g_feats), summed by ``reduce(pairs, sums)``."""
    from satnerf_torch.ops import field_fused as ff

    pairs = ff.heads_reduce_pairs(spec, shared, aux, g, ws["feats"], ws["hid"], ws["ga"],
                                  ws["g_feats"])
    sums = {"b_feats": ws["g_feats"], "b_out": g}
    sums.update({f"b_heads.{k}": v for k, v in ws["ga"].items()})
    return reduce(pairs, sums)


def _exact(pairs, sums) -> dict:
    out = {k: a.double().t() @ b.double() for k, (a, b) in pairs.items()}
    out.update({k: b.double().sum(0) for k, b in sums.items()})
    return out


def _torch_f32(pairs, sums) -> dict:
    out = {k: a.float().t() @ b.float() for k, (a, b) in pairs.items()}
    out.update({k: b.float().sum(0) for k, b in sums.items()})
    return out


def _kernel_sums(pairs, sums) -> dict:
    """K2's reduction (one reduce_op, its bias sums folded as K2 has them)."""
    import torch

    from satnerf_torch.ops import _bwd

    n = next(iter(sums.values())).shape[0]
    out = {k: torch.empty((a.shape[1], b.shape[1]), dtype=torch.float32, device=b.device)
           for k, (a, b) in pairs.items()}
    out.update({k: torch.empty(b.shape[1], dtype=torch.float32, device=b.device)
                for k, b in sums.items()})
    _bwd.reduce_op("field_bwd", "heads_bwd_reduce", torch.float32, n,
                   gemms=[(a, b, out[k]) for k, (a, b) in pairs.items()],
                   sums=[(b, out[k]) for k, b in sums.items()])
    return out


def _rounded(ws) -> dict:
    return {k: ({h: t.float().contiguous() for h, t in v.items()} if isinstance(v, dict)
                else v.float().contiguous()) for k, v in ws.items()}


def variants(spec, shared, aux, g_out, packed) -> dict:
    """{variant: {gradient name: tensor}} of one K2 call: the f64 plain
    version ("truth"), K2 ("kernel"), the f32 plain version ("plain"), and,
    to part the row GEMM from the reduction, K2's workspaces summed exactly
    ("kernel_rows") and the f64 workspaces rounded to f32 summed by K2's
    reduction ("kernel_sums") and by torch in f32 ("plain_sums")."""
    import torch

    from satnerf_torch.ops import field_fused as ff

    d = {k: v.double() for k, v in packed.items()}
    shared64, aux64, g64 = shared.double(), aux.double(), g_out.double()
    truth_ws, kern_ws = {}, {}
    ff.heads_backward_reference(spec, shared64, aux64, g64, d, trace=truth_ws)
    ff._heads_backward_cuda(spec, shared, aux, g_out, packed, True, trace=kern_ws)
    g = g_out.float().contiguous()
    r = _rounded(truth_ws)
    out = {"truth": _grads(spec, shared64, aux64, g64, truth_ws, _exact),
           "kernel": _grads(spec, shared, aux, g, kern_ws, _kernel_sums),
           "kernel_rows": _grads(spec, shared, aux, g, kern_ws, _exact),
           "kernel_sums": _grads(spec, shared, aux, g, r, _kernel_sums),
           "plain_sums": _grads(spec, shared, aux, g, r, _torch_f32)}
    plain_ws = {}
    ff.heads_backward_reference(spec, shared, aux, g_out, packed, trace=plain_ws)
    out["plain"] = _grads(spec, shared, aux, g, plain_ws, _torch_f32)
    torch.cuda.synchronize()
    return out


def _err(x, truth) -> float:
    return float((x.double() - truth.double()).abs().max()
                 / truth.double().abs().max().clamp_min(1e-300))


def step_errors(calls: list) -> dict:
    """Per gradient: each variant's error against the truth, in the worst
    call alone and in the sum over the step's calls (what the step's
    parameter gradient is)."""
    names = sorted({k for c in calls for k in c["truth"]})
    out = {}
    for k in names:
        have = [c for c in calls if k in c["truth"]]
        truth = sum(c["truth"][k] for c in have)
        out[k] = {v: {"call": max(_err(c[v][k], c["truth"][k]) for c in have),
                      "step": _err(sum(c[v][k].double() for c in have), truth)}
                  for v in have[0] if v != "truth"}
    return out


def stages(spec, shared, aux, g_out, packed) -> dict:
    """Each sum of K2 alone on the f64 intermediates rounded to f32."""
    import torch

    from satnerf_torch.ops import _bwd
    from satnerf_torch.ops import field_fused as ff

    f32 = torch.float32
    d = {k: v.double() for k, v in packed.items()}
    trace = {}
    ff.heads_backward_reference(spec, shared.double(), aux.double(), g_out.double(), d,
                                trace=trace)
    r = {k: v.float().contiguous() for k, v in trace.items() if torch.is_tensor(v)}
    for group in ("pre", "hid", "ga"):
        r.update({f"{group}.{k}": v.float().contiguous() for k, v in trace[group].items()})
    n, p = shared.shape[0], packed
    g = g_out.float().contiguous()
    auxp = _bwd.pad_cols(aux, spec.aux_pad)

    def wt(key):  # packed (in, out) -> W^T (out, in), aux rows padded to aux_pad columns
        w = p[key].t()
        return (_bwd.pad_cols(w, spec.aux_pad) if key.endswith("_aux") else w).contiguous()

    # (a) the row GEMM: name -> (width, [(A, Wt)])
    rows = {"fwd.feats": (spec.feat, [(shared, wt("w_feats"))]),
            "fwd.sv0": (spec.fl, [(r["feats"], wt("w_sv0_f")), (auxp, wt("w_sv0_aux"))]),
            "fwd.sv1": (spec.fl, [(r["hid.sv0"], wt("w_sv1"))]),
            "bwd.sv2": (spec.fl, [(g, p["w2_sv"])]),
            "bwd.sv1": (spec.fl, [(r["ga.sv2"], p["w_sv2"])]),
            "bwd.sv0": (spec.fl, [(r["ga.sv1"], p["w_sv1"])])}
    f_prods = [(r["ga.sv0"], p["w_sv0_f"])]
    if spec.heads_on:
        rows["fwd.rgb0"] = (spec.fl, [(r["feats"], wt("w_rgb0"))])
        rows["bwd.rgb0"] = (spec.fl, [(g, p["w2_rgb"])])
        rows["bwd.sky0"] = (spec.fl, [(g, p["w2_sky"])])
        f_prods.insert(0, (r["ga.rgb0"], p["w_rgb0"]))
        for name, w_out, w_f in (("b0", "w2_beta", "w_b0_f"), ("s0", "w2_sem", "w_s0_f")):
            if f"ga.{name}" in r:
                rows[f"bwd.{name}"] = (spec.fl, [(g, p[w_out])])
                f_prods.append((r[f"ga.{name}"], p[w_f]))
    rows["g_feats"] = (spec.feat, f_prods)
    out = {}
    for name, (width, prods) in rows.items():
        got = torch.empty((n, width), dtype=f32, device=shared.device)
        _bwd.row_op("field_bwd", "heads_bwd_row", f32, n, width=width, prods=prods,
                    mode=_bwd.PLAIN, out_f32=got)
        truth = sum(a.double() @ w.double().t() for a, w in prods)
        lib = sum(a @ w.t() for a, w in prods)
        out[f"a.{name}"] = {"kernel": _err(got, truth), "plain": _err(lib, truth),
                            "k": sum(a.shape[1] for a, _ in prods)}
    # (b) dW and (c) the bias sums of the reduction
    pairs = {"w_sv0_aux": (aux, "ga.sv0"), "w_sv0_f": (r["feats"], "ga.sv0"),
             "w_sv1": (r["hid.sv0"], "ga.sv1"), "w_sv2": (r["hid.sv1"], "ga.sv2")}
    if spec.heads_on:
        pairs.update({"w_rgb0": (r["feats"], "ga.rgb0"), "w_sky0_aux": (aux, "ga.sky0")})
        if "ga.b0" in r:
            pairs["w_b0_aux"] = (aux, "ga.b0")
    for key, (a, bname) in pairs.items():
        b = r[bname]
        gw = torch.empty((a.shape[1], b.shape[1]), dtype=f32, device=b.device)
        fold = torch.empty(b.shape[1], dtype=f32, device=b.device)
        apart = torch.empty_like(fold)
        _bwd.reduce_op("field_bwd", "heads_bwd_reduce", f32, n, gemms=[(a, b, gw)],
                       sums=[(b, fold), (b.clone(), apart)])
        truth_w, truth_b = a.double().t() @ b.double(), b.double().sum(0)
        out[f"b.{key}"] = {"kernel": _err(gw, truth_w), "plain": _err(a.t() @ b, truth_w)}
        plain_b = _err(b.sum(0), truth_b)
        out[f"c.fold.{bname}"] = {"kernel": _err(fold, truth_b), "plain": plain_b}
        out[f"c.sum_tile.{bname}"] = {"kernel": _err(apart, truth_b), "plain": plain_b}
        cancel = float(b.double().abs().sum(0).max() / truth_b.abs().max())
        out[f"c.fold.{bname}"]["abs_sum_over_max_sum"] = cancel
    torch.cuda.synchronize()
    return out


def probe(dev) -> list:
    """s * (1 + c * 2^-24) through the row GEMM (one product of K 32 into
    width 64, f32 and bf16 operands), the two terms in one k-step or in two;
    each result beside the exact sum's roundings to f32: to nearest, toward
    zero and toward minus infinity (ulps of 2^-23 from s)."""
    import torch

    from satnerf_torch.ops import _bwd

    cases = [(sign, c, col) for sign in (1.0, -1.0) for c in (1.0, 1.5, 3.0, -1.5)
             for col in (1, 16)]  # the same k-step as the 1, or another one
    a = torch.zeros((len(cases), 32), dtype=torch.float64)
    for i, (sign, c, col) in enumerate(cases):
        a[i, 0], a[i, col] = sign, sign * c * 2.0 ** -24
    wt = torch.zeros((64, 32), dtype=torch.float32)
    wt[:, 0] = wt[:, 1] = wt[:, 16] = 1.0
    exact = a.sum(1)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        # bf16 holds 1 + c * 2^-24 only as two terms of one exact sum: the
        # small term is 2^-24 c exactly in bf16 too
        got = torch.empty((len(cases), 64), dtype=torch.float32, device=dev)
        _bwd.row_op("field_bwd", "heads_bwd_row", dt, len(cases), width=64,
                    prods=[(a.to(dt).to(dev), wt.to(dt).to(dev))], mode=_bwd.PLAIN,
                    out_f32=got)
        for i, (sign, c, col) in enumerate(cases):
            e = float(exact[i])
            rn = float(torch.tensor(e, dtype=torch.float32))
            rz = rn if abs(rn) <= abs(e) else float(torch.nextafter(
                torch.tensor(rn), torch.tensor(0.0)))
            rd = rn if rn <= e else float(torch.nextafter(torch.tensor(rn),
                                                         torch.tensor(-2.0)))
            ulp = 2.0 ** -23
            out.append({"dtype": str(dt).split(".")[-1], "sum": sign, "c": c,
                        "k_step": col // 8, "exact": (e - sign) / ulp,
                        "got": (float(got[i, 0]) - sign) / ulp, "nearest": (rn - sign) / ulp,
                        "toward_zero": (rz - sign) / ulp, "down": (rd - sign) / ulp})
    return out


@contextlib.contextmanager
def plain_parts(parts):
    """Within: the kernels named in ``parts`` ("k1", "k2", "k4", "k5") run
    their plain versions (as ``chip_smoke.plain_versions`` has them), the
    others launch."""
    import torch

    from satnerf_torch.ops import _bwd
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk
    from satnerf_torch.render import renderer

    saved = (ff._forward, ff.heads_backward, trunk.trunk_backward, renderer.composite,
             ff.dot_f32, trunk.dot_f32)
    if "k1" in parts:
        ff._forward = ff._reference_forward
    if "k1_3xtf32" in parts:  # K1's plain version with every product as 3xTF32, RN sums
        def dot_3xtf32(a, w):
            return _bwd.matmul_3xtf32(a, w) if a.dtype == torch.float32 else ff_dot(a, w)
        ff_dot = ff.dot_f32
        ff._forward = ff._reference_forward
        ff.dot_f32 = trunk.dot_f32 = dot_3xtf32
    if "k1_w22" in parts:  # K1's plain version on its weights as 3xTF32 holds them
        def forward_w22(spec, x, aux, packed, resid):
            w22 = {k: (sum(_bwd.split_tf32(v)) if k.startswith("w") else v)
                   for k, v in packed.items()}
            return ff._reference_forward(spec, x, aux, w22, resid)
        ff._forward = forward_w22
    if "k2" in parts:
        def heads_backward(spec, shared, aux, g_out, packed, need_aux=True):
            return ff.heads_backward_reference(spec, shared, aux, g_out, packed)
        ff.heads_backward = heads_backward
    if "k4" in parts:
        def trunk_backward(spec, x, packed, acts, g_shared, need_gx=True):
            return trunk.trunk_backward_reference(spec, x, packed, acts, g_shared)
        trunk.trunk_backward = trunk_backward
    if "k5" in parts:
        renderer.composite = comp.composite_reference
    try:
        yield
    finally:
        ff._forward, ff.heads_backward, trunk.trunk_backward, renderer.composite = saved[:4]
        ff.dot_f32, trunk.dot_f32 = saved[4:]


# which kernels run their plain versions in each f32 step of ``upstream``
UPSTREAM = {"kernels": (), "plain_k1": ("k1",), "plain_k1_w22": ("k1_w22",),
            "plain_k1_3xtf32": ("k1_3xtf32",),
            "plain_k5": ("k5",), "plain_k2": ("k2",), "plain": ("k1", "k2", "k4", "k5")}


def upstream(smoke, pipeline, params, step, n_rays: int, dev) -> dict:
    """The step's gradients with each subset of the kernels in UPSTREAM
    replaced by its plain version (f32, TF32 off), against the plain step in
    f64: {variant: {gradient: err}}. Parts K2's error from what reaches K2
    (K1's outputs and residuals, K5 and its backward through the loss)."""
    batch = smoke.audit_batch(pipeline, n_rays, n_rays, smoke.AUDIT_SEED, dev)
    truth = smoke.audit_engine(pipeline, params, step, batch, dev, "float64", plain=True)
    out = {}
    for name, parts in UPSTREAM.items():
        with plain_parts(parts):
            run = smoke.audit_engine(pipeline, params, step, batch, dev, "float32",
                                     plain=False, precision="highest")
        full_f32()
        out[name] = {k: _err(v, truth["grad"][k]) for k, v in run["grad"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "k2_audit.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k2_audit.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from satnerf_torch.ops import _build

    print(smoke.smi_line(), flush=True)
    t0 = time.monotonic()
    _build.build_all()
    dev = torch.device("cuda")
    full_f32()
    result = {"smi": smoke.smi_line(), "build_s": time.monotonic() - t0,
              "probe": probe(dev), "states": {}}
    print(json.dumps({"probe": result["probe"]}), flush=True)
    with tempfile.TemporaryDirectory() as work:
        for name, make, rays in (
                ("card_test", lambda: card_test_state(os.path.join(work, "c")), CARD_TEST_RAYS),
                ("quality", lambda: quality_state(smoke, os.path.join(work, "q")),
                 smoke.TRAIN_RAYS)):
            pipeline, params, step = make()
            calls = k2_inputs(smoke, pipeline, params, step, rays, dev)
            full_f32()
            per_call, stage = [], []
            for spec, shared, aux, g_out, packed in calls:
                per_call.append(variants(spec, shared, aux, g_out, packed))
                stage.append({"n": int(shared.shape[0]), "heads_on": spec.heads_on,
                              "errors": stages(spec, shared, aux, g_out, packed)})
            errors = step_errors(per_call)
            del per_call
            parts = upstream(smoke, pipeline, params, step, rays, dev)
            audit = smoke.trained_audit(pipeline, params, step, rays, rays, dev)
            full_f32()
            result["states"][name] = {
                "step": int(step), "rays": rays, "gradients": errors, "stages": stage,
                "upstream": parts,
                "trained_audit": {"worst": smoke.audit_worst(audit),
                                  "failures": smoke.audit_failures(audit),
                                  "grad": {k: audit[k]["grad"] for k in (
                                      "float32", "float32_vs_float64",
                                      "plain_float32_vs_float64",
                                      "layered_float32_vs_float32")}}}
            for k, v in errors.items():
                print(json.dumps({"state": name, "gradient": k,
                                  **{f"{var}.{w}": float(f"{e:.3g}") for var, d in v.items()
                                     for w, e in d.items()}}), flush=True)
            worst = sorted(parts["kernels"], key=lambda k: -parts["kernels"][k])[:6]
            for k in worst:
                print(json.dumps({"state": name, "param": k,
                                  **{v: float(f"{e[k]:.3g}") for v, e in parts.items()}}),
                      flush=True)
            print(json.dumps({"state": name, "audit_worst": result["states"][name]
                              ["trained_audit"]["worst"]}), flush=True)
    result["seconds"] = time.monotonic() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"wrote": args.out, "seconds": result["seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
