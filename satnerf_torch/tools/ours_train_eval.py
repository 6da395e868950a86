"""Train the rs_semantic field on a scene at a given configuration and
evaluate its test split, with optional learning-curve horizons (port of the
JAX package's ``tools/ours_train_eval.py``; same flags, defaults and output
files, so the same commands and JSON readers work).

Writes ``<out_dp>/results.json`` (PSNR, SSIM, DSM MAE, semantic accuracy and
mIoU over the test split, per image and mean, plus the training wall clock)
and, for each ``--eval-at`` horizon, ``results_step<N>.json`` with the same
keys and ``train_seconds_to_here``.

Usage:
  python -m satnerf_torch.tools.ours_train_eval <scene_dp> <out_dp>
      [--steps N] [--batch B] [--n-samples S] [--units U] [--seed K]
      [--dtype bfloat16|float32] [--sin-impl poly|poly5|poly7f|exact]
      [--eval-at N,N] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a GPU. The default 8x256
field (the JAX tool's) runs K1 with 128-wide heads on the card.
``--steps-per-dispatch`` K runs blocks of K replays of one
captured step on the card and K calls on the CPU (``train/dispatch.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dp")
    ap.add_argument("out_dp")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n-samples", type=int, default=32)
    ap.add_argument("--units", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--sin-impl", default="poly",
                    help="SIREN sine for training and eval (poly|poly5|poly7f|exact)")
    ap.add_argument("--sc-stride", type=int, default=1,
                    help="solar-correction quadrature stride (1 = the full ladder)")
    ap.add_argument("--beta-ramp-epochs", type=float, default=0.0,
                    help="beta warm-up ramp in epochs; 0 = the step gate")
    ap.add_argument("--steps-per-dispatch", type=int, default=4,
                    help="read and ignored: each step is its own call")
    ap.add_argument("--eval-at", default="",
                    help="comma-separated global steps at which to run the full eval "
                         "mid-training; each writes results_step{N}.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.device import resolve_device
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.train.loop import Trainer

    dev = resolve_device(args.device)  # no GPU, no run
    os.makedirs(args.out_dp, exist_ok=True)
    run = RunConfig(
        dataset_name=os.path.basename(args.scene_dp.rstrip("/")),
        datasets_dp=os.path.dirname(args.scene_dp.rstrip("/")),
        cache_dp=os.path.join(args.out_dp, "cache"),
        workspace_dp=os.path.join(args.out_dp, "training"),
        max_train_steps=args.steps,
        # sparse validation: the tool runs its own full eval at the end
        check_val_every_n_epoch=int(os.environ.get("SATNERF_VAL_EVERY", 40)),
        num_sanity_val_steps=0,
        seed=args.seed,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    pipe = RSSemanticConfig(
        n_samples=args.n_samples,
        fc_units=args.units,
        batch_size=args.batch,
        ignore_car_index=False,
        use_car_reg_loss=True,
        car_reg_loss_start=3,
        lambda_c=1.0,
        compute_dtype=args.dtype,
        sin_impl=args.sin_impl,
        sc_stride=args.sc_stride,
        beta_ramp_epochs=args.beta_ramp_epochs,
    )
    pipeline = load_pipeline(MainConfig(run, pipe))
    pipeline.prepare_run()
    pipeline.load_datasets()
    trainer = Trainer(pipeline, log_every=100, device=dev)

    # at each curve horizon: host seconds since training started, earlier
    # curve evals excluded (the first kernel launches and builds included:
    # a user pays them too)
    eval_overhead = {"s": 0.0}

    def _curve_eval(state, step):
        t_ev = time.time()
        r = evaluate_ours(args, pipeline, state)
        r["train_seconds_to_here"] = t_ev - t0 - eval_overhead["s"]
        eval_overhead["s"] += time.time() - t_ev
        with open(os.path.join(args.out_dp, f"results_step{step}.json"), "w") as f:
            json.dump(r, f, indent=2)
        print(f"[curve] step {step}: psnr={r['psnr']:.2f} mae={r['mae']:.2f} "
              f"acc={r['acc']:.3f} miou={r['miou']:.3f} "
              f"t_train={r['train_seconds_to_here']:.0f}s", flush=True)

    callbacks = {int(s): _curve_eval for s in args.eval_at.split(",")
                 if s.strip() and int(s) < args.steps}
    t0 = time.time()
    state = trainer.fit(step_callbacks=callbacks or None)
    train_seconds = time.time() - t0

    results = evaluate_ours(args, pipeline, state)
    # host clock including the first launches; not a throughput measurement
    results["train_wall_seconds_incl_compile"] = train_seconds
    results["train_seconds_excl_curve_evals"] = train_seconds - eval_overhead["s"]
    results["steps"] = args.steps
    results["it_per_s_wall"] = args.steps / train_seconds
    with open(os.path.join(args.out_dp, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: v for k, v in results.items() if k != "history"}, indent=2))
    return 0


def evaluate_ours(args, pipeline, state) -> dict:
    """The test split of ``pipeline`` rendered from ``state.params`` on the
    device they live on (chunks of 8,192 rays, the deterministic ladder) ->
    {"psnr", "ssim", "mae", "acc", "miou", "per_image"}; the DSMs go under
    ``args.out_dp``. Solar correction is off: no metric reads its pass."""
    from satnerf_torch.eval import metrics
    from satnerf_torch.eval.dsm import compute_dsm_and_mae
    from satnerf_torch.eval.semantic_metrics import (
        confusion_matrix,
        semantic_accuracy,
        semantic_miou,
    )
    from satnerf_torch.render.renderer import render_image_chunked

    dev = next(state.params["field"].parameters()).device
    test = pipeline.datasets["rgb_test"]
    rcfg = replace(pipeline.step_config(1, device=dev).render, solar_correction=False)
    out: dict = {"per_image": {}}
    psnrs, ssims, maes, accs = [], [], [], []
    conf_total = None
    for i in range(1, len(test.data)):  # skip the prepended train view
        img = test.image_item(i)
        res = render_image_chunked(state.params, rcfg, img["rays"], img["extras"],
                                   chunk=8192, device=dev)
        h, w = img["h"], img["w"]
        gt = img["rgbs"].reshape(h, w, 3)
        pred = res["rgb"].reshape(h, w, 3)
        psnr_ = float(metrics.psnr(pred, gt))
        ssim_ = float(metrics.ssim(pred, gt))
        mae = compute_dsm_and_mae(test, img["rays"], res["depth"], args.out_dp,
                                  img["name"], 0)
        sem_pred = res["semantic_logits"].argmax(-1)
        sem_gt = np.asarray(img["semantic"]).reshape(-1)
        acc = semantic_accuracy(sem_pred, sem_gt)
        conf = confusion_matrix(sem_pred, sem_gt, test.semantic_n_classes, normalize=None)
        conf_total = conf if conf_total is None else conf_total + conf
        out["per_image"][img["name"]] = {"psnr": psnr_, "ssim": ssim_,
                                         "mae": float(mae["mean"]), "acc": acc}
        psnrs.append(psnr_)
        ssims.append(ssim_)
        maes.append(float(mae["mean"]))
        accs.append(acc)
    out["psnr"] = float(np.mean(psnrs))
    out["ssim"] = float(np.mean(ssims))
    out["mae"] = float(np.mean(maes))
    out["acc"] = float(np.mean(accs))
    out["miou"] = float(semantic_miou(conf_total))
    return out


if __name__ == "__main__":
    raise SystemExit(main())
