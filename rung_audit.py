#!/usr/bin/env python3
"""Train the 256² validation rung in one of three engine variants, and hold
the kernels against their plain versions at its trained states, on one card.

    python3 rung_audit.py <out_root> --variant kernels_bf16|kernels_f32|plain_f32
        [--seed S] [--stop-at N] [--audit-at N,N] [--eval-at N,N] [--render-at N,N]
        [--gate] [--resume]

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
``--resume`` continues the newest run under ``<out_root>/training``.
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
VARIANTS = ("kernels_bf16", "kernels_f32", "plain_f32")
AUDIT_RAYS = 4096
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


def _add_callbacks(args, smoke) -> None:
    """Wrap ``syn_long_run``'s horizon callbacks with the audits and the stop."""
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
                audit = smoke.trained_audit(trainer.pipeline, state.params, step,
                                            AUDIT_RAYS, AUDIT_RAYS, trainer.device)
                audit["worst"] = smoke.audit_worst(audit)
                audit["beyond_bars"] = smoke.audit_failures(audit)
                with open(os.path.join(args.out_root, f"audit_step{step}.json"), "w") as f:
                    json.dump(audit, f, indent=1)
                print(json.dumps({"audit_step": step, "worst": audit["worst"],
                                  "beyond_bars": audit["beyond_bars"]}), flush=True)
            if step == args.stop_at:
                trainer.request_stop()

        steps = set(evals) | set(args.audit_at) | set(args.render_at) | ({args.stop_at} - {0})
        return {s: at_step for s in steps}

    syn_long_run._curve_evals = callbacks


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
    ap = argparse.ArgumentParser()
    ap.add_argument("out_root")
    ap.add_argument("--variant", choices=VARIANTS, required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--stop-at", type=int, default=0)
    ap.add_argument("--audit-at", type=_steps, default=[])
    ap.add_argument("--eval-at", default="")
    ap.add_argument("--render-at", type=_steps, default=[])
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
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
    _apply_variant(args.variant)
    _add_callbacks(args, smoke)
    with smoke.plain_versions() if args.variant == "plain_f32" else contextlib.nullcontext():
        rc = syn_long_run.main([args.out_root, "--seed", str(args.seed),
                                "--eval-at", args.eval_at, *(GATE if args.gate else RUNG),
                                *(["--resume"] if args.resume else [])])
    print(json.dumps({"peak_gb": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
