"""Generate the synthetic validation scene and launch or resume the
production run on it (port of the JAX package's ``tools/syn_long_run.py``,
all of its flags; the validation rungs of ``docs/validation_run.md``).

Regenerates the scene (8x256^2 train + 3 test views, 16k bundle-adjustment
tie points by default) unless ``<out_root>/scene/root.json`` exists, and
trains the flagship ``rs_semantic`` configuration: 8x512 SIREN, 64 samples a
ray, batch 8192, bf16 + the poly sine, depth supervision for the first
quarter of training, car-reg from epoch 3. The scene and the workspace live
under ``out_root``.

A run can span several processes (for example calls with a time limit):
SIGTERM or SIGINT ends a session after the step in flight with
``ckpoints/last`` written (``timeout -s TERM <secs> python -m ...``), and
``--resume`` continues the newest run under ``<out_root>/training`` from
it, bit for bit as one uninterrupted run (``run/resume_training.py``).
The run keeps the length it was created with: ``--steps`` and the
pipeline flags are read from the run's own configs on ``--resume``.
``--eval-at N,N`` evaluates the test split at those global steps
(``tools/ours_train_eval.evaluate_ours``) into
``<out_root>/results_step<N>.json``.

Usage:
  python -m satnerf_torch.tools.syn_long_run <out_root> [--seed K] [--steps N]
      [--resume] [--eval-at N,N] [--val-every E] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_root", help="run root (scene + workspace live here)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--val-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="resume the newest run in the workspace from its last checkpoint")
    # hierarchical (coarse-to-fine) variant: the launcher drops to batch 4096
    # and remat_chunks 2 when it is enabled
    ap.add_argument("--n-importance", type=int, default=0)
    ap.add_argument("--use-fine-network", action="store_true")
    ap.add_argument("--sc-stride", type=int, default=1,
                    help="solar-correction quadrature stride (1 = the full ladder)")
    # smoke-test overrides (None = production sizes)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--warm-start", default=None, metavar="CKPT",
                    help="params-only warm start from a checkpoint file (fresh optimizer, "
                         "step 0; a hierarchical run seeds its fine field from the "
                         "source's coarse one)")
    ap.add_argument("--learnrate", type=float, default=None)
    ap.add_argument("--posenc-freq", type=int, default=None)
    ap.add_argument("--run-postfix", default=None,
                    help="override the derived run_name_postfix")
    ap.add_argument("--first-beta-epoch", type=int, default=None)
    ap.add_argument("--val-chunk-rays", type=int, default=None)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--n-train", type=int, default=8)
    ap.add_argument("--n-test", type=int, default=3)
    ap.add_argument("--tie-points", type=int, default=16000)
    ap.add_argument("--eval-at", default="",
                    help="comma-separated global steps at which to evaluate the test split "
                         "into <out_root>/results_step{N}.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from satnerf_torch.device import resolve_device

    dev = resolve_device(args.device)  # no GPU, no scene and no run
    os.makedirs(args.out_root, exist_ok=True)
    if args.resume:
        ws = os.path.join(args.out_root, "training")
        runs = sorted(d for d in os.listdir(ws) if os.path.isdir(os.path.join(ws, d))) \
            if os.path.isdir(ws) else []
        if not runs:
            print("[syn_long] --resume given but no run dir found", flush=True)
            return 1
        from satnerf_torch.run.resume_training import prepare_resume

        trainer = prepare_resume(os.path.join(ws, runs[-1]), device=dev)
    else:
        trainer = _new_run(args, dev)
    run = trainer.cfg.run
    state = trainer.fit(step_callbacks=_curve_evals(args, trainer) or None)
    done = state.step >= run.max_train_steps
    print(f"[syn_long] {trainer.steps_timed} steps timed at {trainer.ms_per_step:.2f} ms a "
          "step (host clock; validations, evals and checkpoints excluded)", flush=True)
    print(f"[syn_long] {'done' if done else f'stopped at step {state.step}'}: {run.run_dp}",
          flush=True)
    return 0


def _new_run(args, dev):
    """Generate the scene where it is missing and build the run's Trainer."""
    scene_dp = os.path.join(args.out_root, "scene")
    if not os.path.isfile(os.path.join(scene_dp, "root.json")):
        from satnerf_torch.datasets.synthetic import generate_scene

        print(f"[syn_long] generating {args.n_train}+{args.n_test}-view "
              f"{args.img_size}^2 scene ...", flush=True)
        generate_scene(scene_dp, n_train=args.n_train, n_test=args.n_test,
                       img_size=args.img_size, n_tie_points=args.tie_points,
                       aoi_name="SYN_LONG", seed=0)

    from satnerf_torch.configs import MainConfig, RSSemanticConfig, RunConfig
    from satnerf_torch.pipelines import load_pipeline
    from satnerf_torch.run.training import apply_matmul_precision
    from satnerf_torch.train.loop import Trainer

    run = RunConfig(
        dataset_name="scene",
        datasets_dp=args.out_root,
        cache_dp=os.path.join(args.out_root, "cache"),
        workspace_dp=os.path.join(args.out_root, "training"),
        max_train_steps=args.steps,
        check_val_every_n_epoch=args.val_every,
        num_sanity_val_steps=0,
        deterministic=True,
        seed=args.seed,
        steps_per_dispatch=8,
        run_name_postfix=(
            args.run_postfix if args.run_postfix is not None
            else "hier" if args.n_importance > 0
            else f"sc{args.sc_stride}" if args.sc_stride != 1
            else ""
        ),
        warm_start_fp=args.warm_start,
    )
    pipe_kwargs = dict(batch_size=8192, compute_dtype="bfloat16", ignore_car_index=False,
                       use_car_reg_loss=True, car_reg_loss_start=3, lambda_c=1.0,
                       sc_stride=args.sc_stride)
    if args.n_importance > 0:
        pipe_kwargs.update(n_importance=args.n_importance,
                           use_fine_network=args.use_fine_network, batch_size=4096,
                           remat_chunks=2)
    for flag, key in (("val_chunk_rays", "val_chunk_rays"),
                      ("first_beta_epoch", "first_beta_epoch"), ("batch", "batch_size"),
                      ("units", "fc_units"), ("learnrate", "learnrate"),
                      ("posenc_freq", "mapping_pos_n_freq")):
        if getattr(args, flag) is not None:
            pipe_kwargs[key] = getattr(args, flag)
    cfgs = MainConfig(run, RSSemanticConfig(**pipe_kwargs))
    apply_matmul_precision(run.matmul_precision)
    cfgs.create_run_dp()
    pipeline = load_pipeline(cfgs)
    pipeline.prepare_run()
    pipeline.load_datasets()
    return Trainer(pipeline, device=dev)


def _curve_evals(args, trainer) -> dict:
    """{step: callback} writing the test-split eval at each ``--eval-at``
    step of this session into ``<out_root>/results_step<N>.json``."""
    from satnerf_torch.tools.ours_train_eval import evaluate_ours

    pipeline = trainer.pipeline
    out = argparse.Namespace(out_dp=os.path.join(args.out_root, "curve"))
    os.makedirs(out.out_dp, exist_ok=True)

    def _eval(state, step):
        r = evaluate_ours(out, pipeline, state)
        r["step"] = step
        with open(os.path.join(args.out_root, f"results_step{step}.json"), "w") as f:
            json.dump(r, f, indent=2)
        print(f"[syn_long] step {step}: psnr={r['psnr']:.2f} ssim={r['ssim']:.3f} "
              f"mae={r['mae']:.3f} acc={r['acc']:.4f} miou={r['miou']:.3f}", flush=True)

    return {int(s): _eval for s in args.eval_at.split(",") if s.strip()}


if __name__ == "__main__":
    raise SystemExit(main())
