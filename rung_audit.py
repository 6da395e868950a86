#!/usr/bin/env python3
"""Train the 256² validation rung in one of three engine variants, and hold
the kernels against their plain versions at its trained states, on one card.

    python3 rung_audit.py <out_root> --variant kernels_bf16|kernels_f32|plain_f32
        [--seed S] [--stop-at N] [--audit-at N,N] [--eval-at N,N] [--render-at N,N]
        [--gate | --hier] [--resume] [--carry-in FILE] [--carry-out FILE]

The run is ``python -m satnerf_torch.tools.syn_long_run <out_root>
--img-size 256 --n-train 8 --n-test 2 --batch 4096 --steps 8000`` (the rung
of ``docs/validation_run.md:47-70``: 8x512 rs_semantic, 64 samples, the poly
sine, 4,096 + 4,096 depth rays to step 2,000), driven through that entry
point with the variant applied to the pipeline it builds:

- ``kernels_bf16``: as the tool runs it (the kernels, bf16, library matmuls
  at the run's precision "high");
- ``kernels_f32``: the kernels in f32 (3xTF32), library matmuls at
  "highest";
- ``plain_f32``: the plain versions of K1, K2, K4 and K5 on the card
  (``chip_smoke.plain_versions``: the same autograd functions and packed
  weights, f32, TF32 off) for training, validation and the evals alike.

``--eval-at`` evaluates the test split (``evaluate_ours``) into
``<out_root>/results_step<N>.json``; ``--audit-at`` (``kernels_*`` only) runs
``chip_smoke.trained_audit`` on one 4,096 + 4,096 batch of the scene at the
live state into ``<out_root>/audit_step<N>.json``; ``--render-at`` saves the
render of the first test view (rgb, depth, semantic logits and labels, and
beta composited along each ray, as ``evaluate_ours`` renders it) into
``<out_root>/render_step<N>.npz``;
``--stop-at`` ends the run after that step with ``ckpoints/last`` written
(the schedule and the depth drop stay those of the 8,000-step run). Then
``python -m satnerf_torch.eval.eval <run_dp> --splits test [--ckpt last]``
evaluates a finished run.

``--gate`` trains the JAX package's quality gate in place of the rung:
``syn_long_run <out_root> --steps 8000 --sc-stride 1`` with the launcher's
defaults (batch 8,192, 8 + 3 views of 256², 16,000 tie points;
``docs/performance.md`` "Strided solar-correction quadrature").
``--hier`` trains the JAX package's hierarchical production run in place of
the rung: ``syn_long_run <out_root> --n-importance 128 --use-fine-network
--steps 30000`` with the launcher's defaults (batch 4,096 and
``remat_chunks`` 2 for the fine pass, 64 + 128 samples, the fine field apart,
8 + 3 views of 256², 16,000 tie points), stopped after step 12,900 unless
``--stop-at`` says otherwise: the schedule of 30,000 steps, so the depth drop
falls at step 7,500 (``docs/validation_run.md`` "Hierarchical (coarse-to-fine)
production run"). A hierarchical step takes about three times the gate's
field points, so ``--audit-at`` halves its rays (down to AUDIT_MIN_RAYS) where
the card runs out of memory, and writes how many it took.
``--resume`` continues the newest run under ``<out_root>/training``.
``--carry-out FILE`` packs that run's ``configs/`` and ``ckpoints/last.ckpt``
into one file at the end (the checkpoint in byte planes, deflated: a
hierarchical run's ``last.ckpt`` of 68 MB packs to about 58), and
``--carry-in FILE`` unpacks such a file under ``<out_root>/training`` first,
so that a run spans processes whose files do not outlive them.
It needs one card and exits with 2 without one; it prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
RUNG = ["--img-size", "256", "--n-train", "8", "--n-test", "2", "--batch", "4096",
        "--steps", "8000"]
GATE = ["--steps", "8000", "--sc-stride", "1"]
HIER = ["--n-importance", "128", "--use-fine-network", "--steps", "30000"]
HIER_STOP = 12900  # where the JAX package stopped its hierarchical run
VARIANTS = ("kernels_bf16", "kernels_f32", "plain_f32")
AUDIT_RAYS = 4096
AUDIT_MIN_RAYS = 1024
RENDER_KEYS = ("rgb", "depth", "semantic_logits", "semantic_label")


def _steps(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def _apply_variant(variant: str) -> None:
    """Patch the pipeline that ``syn_long_run`` loads into ``variant``'s
    dtype and matmul precision."""
    import torch

    from satnerf_torch import pipelines
    from satnerf_torch.device import disable_tf32

    if variant == "kernels_bf16":
        return
    load = pipelines.load_pipeline

    def load_variant(cfgs):
        cfgs.pipeline.compute_dtype = "float32"
        cfgs.run.matmul_precision = "highest"
        torch.set_float32_matmul_precision("highest")
        disable_tf32()
        return load(cfgs)

    pipelines.load_pipeline = load_variant


def _add_callbacks(args, smoke, peak: dict) -> None:
    """Wrap ``syn_long_run``'s horizon callbacks with the audits and the stop;
    ``peak["run"]`` keeps the run's peak device bytes apart from the audits'."""
    from satnerf_torch.tools import syn_long_run

    curve_evals = syn_long_run._curve_evals

    def callbacks(tool_args, trainer):
        evals = curve_evals(tool_args, trainer)

        def at_step(state, step):
            if step in evals:
                evals[step](state, step)
            if step in args.render_at:
                _save_render(trainer.pipeline, state.params,
                             os.path.join(args.out_root, f"render_step{step}.npz"), step)
            if step in args.audit_at:
                audit = _audit(smoke, trainer, state, step, peak)
                with open(os.path.join(args.out_root, f"audit_step{step}.json"), "w") as f:
                    json.dump(audit, f, indent=1)
                print(json.dumps({k: audit.get(k) for k in (
                    "step", "rays", "peak_gb", "seconds", "worst", "beyond_bars", "error")}),
                    flush=True)
            if step == args.stop_at:
                trainer.request_stop()

        steps = set(evals) | set(args.audit_at) | set(args.render_at) | ({args.stop_at} - {0})
        return {s: at_step for s in steps}

    syn_long_run._curve_evals = callbacks


def _audit(smoke, trainer, state, step: int, peak: dict) -> dict:
    """``chip_smoke.trained_audit`` at the live state on AUDIT_RAYS + AUDIT_RAYS
    rays, halved while the card runs out of memory (down to AUDIT_MIN_RAYS;
    the training state is not touched: the audit steps copies) -> the audit
    with its worst errors, those beyond the bars, its peak GB and seconds."""
    import time

    import torch

    rays, t0 = AUDIT_RAYS, time.monotonic()
    peak["run"] = max(peak["run"], torch.cuda.max_memory_allocated())
    while True:
        torch.cuda.reset_peak_memory_stats()
        try:
            audit = smoke.trained_audit(trainer.pipeline, state.params, step, rays, rays,
                                        trainer.device)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        torch.cuda.empty_cache()
        if rays <= AUDIT_MIN_RAYS:
            return {"step": step, "rays": rays, "error": "out of memory",
                    "seconds": time.monotonic() - t0}
        print(f"rung_audit: the audit at {rays} + {rays} rays ran out of memory; halving",
              flush=True)
        rays //= 2
    audit["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    audit["worst"] = smoke.audit_worst(audit)
    audit["beyond_bars"] = smoke.audit_failures(audit)
    audit["seconds"] = time.monotonic() - t0
    return audit


def _newest_run(out_root: str) -> str | None:
    ws = os.path.join(out_root, "training")
    runs = sorted(d for d in os.listdir(ws) if os.path.isdir(os.path.join(ws, d))) \
        if os.path.isdir(ws) else []
    return os.path.join(ws, runs[-1]) if runs else None


def _planes(raw: bytes, size: int | None = None) -> bytes:
    """Bytes -> their four byte planes (``size`` given: the inverse, cut to
    ``size``): an f32 tensor's sign-and-exponent bytes then lie together."""
    import numpy as np

    if size is not None:
        return np.frombuffer(raw, np.uint8).reshape(4, -1).T.tobytes()[:size]
    pad = b"\0" * (-len(raw) % 4)
    return np.frombuffer(raw + pad, np.uint8).reshape(-1, 4).T.tobytes()


def pack_run(run_dp: str, fp: str) -> None:
    """``run_dp``'s ``configs/`` and ``ckpoints/last.ckpt`` -> one zip at
    ``fp`` (the checkpoint in byte planes), for ``unpack_run``."""
    import zipfile

    os.makedirs(os.path.dirname(os.path.abspath(fp)), exist_ok=True)
    with zipfile.ZipFile(fp, "w", zipfile.ZIP_DEFLATED, compresslevel=6) as z:
        z.writestr("run_name", os.path.basename(run_dp))
        for root, _, files in os.walk(os.path.join(run_dp, "configs")):
            for name in files:
                path = os.path.join(root, name)
                z.write(path, os.path.relpath(path, run_dp))
        with open(os.path.join(run_dp, "ckpoints", "last.ckpt"), "rb") as f:
            raw = f.read()
        z.writestr("ckpoints/last.ckpt.size", str(len(raw)))
        z.writestr("ckpoints/last.ckpt.planes", _planes(raw))


def unpack_run(fp: str, out_root: str) -> str:
    """A ``pack_run`` file -> its run under ``<out_root>/training`` -> the run dir."""
    import zipfile

    with zipfile.ZipFile(fp) as z:
        run_dp = os.path.join(out_root, "training", z.read("run_name").decode())
        for name in z.namelist():
            if name.startswith("configs/"):
                z.extract(name, run_dp)
        os.makedirs(os.path.join(run_dp, "ckpoints"), exist_ok=True)
        size = int(z.read("ckpoints/last.ckpt.size"))
        with open(os.path.join(run_dp, "ckpoints", "last.ckpt"), "wb") as f:
            f.write(_planes(z.read("ckpoints/last.ckpt.planes"), size))
    return run_dp


def run_argv(args) -> list:
    """The ``syn_long_run`` command line of ``args``."""
    run = HIER if args.hier else GATE if args.gate else RUNG
    return [args.out_root, "--seed", str(args.seed), "--eval-at", args.eval_at, *run,
            *(["--resume"] if args.resume else [])]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_root")
    ap.add_argument("--variant", choices=VARIANTS, required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--stop-at", type=int, default=None,
                    help=f"end after this step (default: {HIER_STOP} with --hier, else none)")
    ap.add_argument("--audit-at", type=_steps, default=[])
    ap.add_argument("--eval-at", default="")
    ap.add_argument("--render-at", type=_steps, default=[])
    run = ap.add_mutually_exclusive_group()
    run.add_argument("--gate", action="store_true")
    run.add_argument("--hier", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--carry-in", default=None, metavar="FILE")
    ap.add_argument("--carry-out", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if args.stop_at is None:
        args.stop_at = HIER_STOP if args.hier else 0
    return args


def _save_render(pipeline, params: dict, fp: str, step: int) -> None:
    """The first test view rendered as ``evaluate_ours`` renders it -> ``fp``."""
    from dataclasses import replace

    import numpy as np

    from satnerf_torch.render.renderer import render_image_chunked

    dev = next(params["field"].parameters()).device
    img = pipeline.datasets["rgb_test"].image_item(1)  # 0 is the prepended train view
    rcfg = replace(pipeline.step_config(1, device=dev).render, solar_correction=False)
    res = render_image_chunked(params, rcfg, img["rays"], img["extras"], chunk=8192,
                               device=dev)
    # the per-ray outputs the image consumers read; beta composited along
    # the ray (the per-sample tensors are 64 times larger)
    rays = {k: res[k] for k in RENDER_KEYS if k in res}
    if "beta" in res:
        rays["beta_composited"] = (res["weights"][..., None] * res["beta"]).sum(axis=-2)[:, 0]
    np.savez_compressed(fp, name=img["name"], step=step, h=img["h"], w=img["w"], **rays)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rung_audit: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.audit_at and args.variant == "plain_f32":
        print("rung_audit: --audit-at needs a kernels_* variant", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from satnerf_torch.tools import syn_long_run

    print(smoke.smi_line(), flush=True)
    if args.carry_in:
        print(f"rung_audit: unpacked {unpack_run(args.carry_in, args.out_root)}", flush=True)
    _apply_variant(args.variant)
    peak = {"run": 0}
    _add_callbacks(args, smoke, peak)
    with smoke.plain_versions() if args.variant == "plain_f32" else contextlib.nullcontext():
        rc = syn_long_run.main(run_argv(args))
    print(json.dumps({"peak_gb": max(peak["run"], torch.cuda.max_memory_allocated()) / 2**30}),
          flush=True)
    if args.carry_out and rc == 0:
        pack_run(_newest_run(args.out_root), args.carry_out)
        print(f"rung_audit: packed into {args.carry_out} "
              f"({os.path.getsize(args.carry_out) / 1e6:.2f} MB)", flush=True)
    return rc

if __name__ == "__main__":
    sys.exit(main())
