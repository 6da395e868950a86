#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (satnerf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the CUDA kernels from ``satnerf_torch/csrc`` and runs, printing one
JSON line per phase:

1. device and toolchain;
2. the kernel build (one nvcc per source, in parallel), with the HGMMA
   (wgmma) count in the SASS of each tensor-core kernel (K1, K2, K3, K4, K6)
   and its registers and spills;
3. the sine engines of ``csrc/sine.cuh`` and their cosines against
   ``ops/fastmath.py``;
4. the fused field kernel against its plain PyTorch version at the
   flagship width (rs_semantic 8x512), f32 and bf16, both head variants,
   256- and 512-wide heads, at 1, 63, 64, 65 and 65,537 points, each run
   twice for bitwise-equal outputs;
5. the compositing kernel K5 against its plain version at the main path's
   four shapes and ragged ones, on the renderer's strided sun/sky views,
   twice (bitwise equal) and on contiguous copies (bitwise equal);
6. the serving path: a ``RenderService`` on seeded weights answers three
   128x128 requests through both kernels (launch counters prove it), its
   first 1,024 rays are held against the plain path on the CPU, and one
   solar-correction render runs the sigma+sun-only field variant;
7. CUDA-event times of each kernel and its plain version at the serve
   shapes, beside the least time the card could take; the field kernel is
   held against its plain version at that shape too; K5's device times
   (``device_time``: the timed calls queue behind a ``torch.cuda._sleep``
   that outlasts their host issue, on inputs rotated past the L2) and the
   host's issue µs per call;
8. the backward kernels at the flagship width: K1's residuals, the heads
   backward (K2) and the trunk backward (K4, both engines) against their
   plain versions, f32 and bf16, both head variants, and run twice for
   bitwise-equal gradients; the compositing backward (K5) against autograd
   of its plain version at K5's shapes, as phase 5;
9. training: five flagship RS-Semantic steps (1,024 rays + 1,024 depth
   rays, every loss term on) through the kernels, with the launch counts
   of every kernel and no plain version; one 32-ray step held against the
   same step on the CPU; one step with the "stored" trunk backward held
   against "recompute"; CUDA-event times of each kernel at the training
   shapes, K2 and K4 in f32 and bf16 with their row-GEMM launches and
   reductions apart, beside both bounds and one torch.matmul per building
   block, each building block alone at that matmul's shape, and K2 and K4
   at 256x128 and 1,024x512 (with ``--parent DIR``, an older checkout's
   K1-K4 in turns with these, each in its own process, and K1/K3's f32
   outputs held against its within the field bars; K5's device times and
   the flagship, Path B and bench-configuration step times in the same
   turns); phase ``composite_device_times``: K5 and
   its backward beside the card's empty-kernel launch time, their byte
   bound and ``torch.profiler``'s device time; the K1/K3 weight preparations of every step (one per field);
   ``torch.profiler`` over two steady steps (kernels by device time, the
   device's idle share);
10. the trunk-only kernel K3 against its plain version at the flagship
   width (f32 and bf16, with and without the "stored" pre-activations, at
   1, 63, 64, 65 and 65,537 points, each run twice for bitwise-equal
   results) and its interleaved variant K6 at 1, 63, 64, 65, 127, 128, 129
   and 65,537 points (run twice, bitwise equal to each other and to K3, and
   within the field bar of the plain version);
11. the RS-Semantic ablation field with its semantic beta head
   (``use_separate_beta_for_s``, ``use_beta_for_s``; trunk through K3):
   five training steps with exact launch counts, a 32-ray step against the
   CPU, and one 128x128 request against the CPU plain path;
12. the hierarchical configuration (``n_importance`` 128, a fine field,
   ``remat_chunks`` 2, ``sc_stride`` 2): five training steps with exact
   launch counts and every ``c_`` loss term finite, a 32-ray step against
   the CPU, and one 128x128 request through the fine field with the
   ``_coarse`` outputs held against the CPU;
13. K3 and K6 in turns (K3, K6, K6, K3; ``cuda_ms`` and ``device_time``)
   beside their bounds and the plain version: f32 at 65,536, 131,072 and
   1,048,576 points, bf16 at the interleave prototype's 1,048,576 x 63
   (K6 checked there in both dtypes); with ``--parent``, the parent's K6
   at that shape in the same turns;
13b. ``widths``: every trunk width the JAX kernels take below 512
   (``WIDTH_PAIRS``: (128, 64), (128, 128), (256, 128), (256, 256),
   (384, 192), (384, 384) at the rs_semantic TOML's 8 layers): K1 (both
   head variants) with K2 and K4 (both engines) on its residuals, or K3
   (with and without the pre-activations) with K4, against their plain
   versions at 1, 63, 65 and 65,536 points in f32 and bf16 within the bars
   above, each run twice and bitwise equal; each kernel's device ms at
   65,536 points beside its bound; the four-scene workflow's training
   (``tools/four_scenes.py``'s TOMLs: 8 x 256, 32 samples, 2,048 rays, bf16,
   depth on, ``steps_per_dispatch`` 8) through ``start_training`` for 24
   steps, with K1, K2, K4, K5 and K5's backward launched by the schedule and
   no plain version; the examples' 2 x 128 field in the flagship step config
   (K3, K4 and K5 every step, a 32-ray step against the CPU); with
   ``--parent``, the parent's build seconds and K1-K4's outputs at 512
   bitwise equal to the parent build's, K2/K4 in bf16 within
   ``PARENT_BARS`` (``port_times`` saves all four);
13c. ``input_widths``: encoded inputs past 64 wide (``INPUT_FREQS``: 11,
   12, 16 and 21 frequencies, c_in 66, 72, 96 and 126, 80 to 128 after
   padding) at every trunk width (128, 256, 384, 512; 8 layers, heads K1
   takes) in f32 and bf16 at 65,536 points: K1 (both head variants, with the
   "stored" residuals), K3 (with and without the pre-activations) and K4
   (both engines, gx included) against their plain versions within the bars
   above, each run twice and bitwise equal; K1's, K3's and K4's device ms
   beside their bounds at 512 wide and c_in 60, 72 and 126; the rs_semantic TOML at 12
   frequencies trained five flagship steps (K1, K2, K4, K5 and K5's backward
   every step, no plain version, a 32-ray step against the CPU) and served
   one 128x128 request; with ``--parent``, K1-K4's outputs at c_in 60
   as at 512 (``parent_outputs_check``), and their times in turns;
14. ``train_scene``: the training CLI end to end on a generated scene (4 + 1
   views, 96x96, 300 tie points): ``run.training.start_training`` on the
   flagship TOML as it is, 144 steps (the depth drop at step 36, the beta
   gate at epoch 2), validation with PSNR, SSIM, the DSM MAE and the
   visualizers every epoch (each TIF of each image counted), checkpoints; the launches of K1, K2, K4, K5 and K5's backward by the
   step and validation schedule and no plain version, one K1 weight
   preparation per step and per validation, finite loss terms, the batch's
   plain rgb MSE falling and the train PSNR rising, the run layout,
   the native host library loaded; the same run stopped by
   ``request_stop`` at step 72 and resumed by ``run.resume_training``
   (params bitwise equal to the uninterrupted run's); the ``best``
   checkpoint served by ``RenderService.from_checkpoint`` against that
   validation's render; the loop's host-clock ms per step, seconds per
   validation, DSM/MAE and checkpoint save/restore, and peak memory;
   ``train_dispatch``: ``steps_per_dispatch`` 8 against 1 (blocks of replays
   of one captured step, ``train/dispatch.py``) through ``Trainer.fit`` at
   the flagship TOML, Path A and Path B on a 48 x 48 scene across the depth
   drop, epoch ends and the beta gate: parameters, Adam's moments and count
   and the last metrics bitwise equal, the same launches and weight
   preparations, a replayed depth step launching what the path's step
   launches; the training CLI on the scene for one epoch and its validation
   at both K, ``last.ckpt`` bitwise equal; ms a step at K = 1 and 8 in turns
   at the flagship and the bench's configurations, capture seconds, peak
   memory and each K's idle share over two steps (``torch.profiler``). In
   every phase a replayed step counts the launches captured for its one step
   (``count_replays``);
15. ``eval_scene``: the eval battery (``eval.eval.eval_all``) on run A,
   inline over the train and test splits: K1 and K5 once per chunk of every
   image, one K1 weight preparation, no plain version; every results.json
   value finite (SSIM at most 1, accuracy and mIoU in [0, 1]); the test
   split's PSNR and MAE those of the validation that saved ``best``; one
   PLY point per ray; the test split again through fresh worker processes,
   one image each, with the same results.json text; seconds per image in
   the render, PSNR/SSIM with the DSM/MAE, the semantic metrics and the
   point clouds;
16. ``serve_view``: run A served by view name over HTTP (``load_service``,
   ``serve_in_thread``): each view's PNG decodes to the served rgb, the f16
   arrays within 1e-3, a relit request, the 400 and 404 routes, the first
   1,024 rays against the CPU plain path, a ``fast_sine`` service through
   K1 on poly5 against the plain poly5 version; host ms per request by view
   (``build_view_rays``, the render, PNG and HTTP) and rays/s;
17. ``viz_scene``: ``run_visualizer`` over run A's test and train splits:
   every visualizer's TIF for every image, the rgb TIF equal to the render,
   K1 and K5 once per chunk, no plain version; seconds per image in the
   render and in the visualizers;
18. ``train_dp``: the flagship TOML on the scene for one epoch (36 steps,
   one validation) over two gloo ranks on the one card (NCCL refuses two
   ranks on one device), each a ``--dp-rank`` process started with
   torchrun's environment, in one process, and as the one rank of an nccl
   group: losses within rtol 2e-5 of one process at every step and
   parameters within 1e-6, each rank's launches by the schedule, no plain
   version; ms per step per rank and the collectives' share (two ranks
   share the card: a price, not a speed-up);
19. ``sweep``: ``run.automated_training.launch`` of a two-experiment TOML,
   8 steps each: both runs leave ``last.ckpt`` and a validation;
20. ``prep_scene``: a DFC2019 Track-3 distribution of JAX_068 (14 views of
   384x384 from ``generate_scene``, ``tests/torch_dfc_case.py``) made into a
   training dataset by ``python -m satnerf_torch.data_prep.create_dataset``
   (the adapter, cropping, the native bundle adjustment, meta extraction,
   root.json, semantic masks on the cropped grid; host seconds per step, the
   BA's tracks and reprojection under 1 px), a second run skipping every
   step; 200 flagship steps on it through ``start_training`` (the sanity
   validation and the run's last: PSNR, SSIM, the DSM MAE against the GT DSM
   the adapter georegistered) with the launches of K1, K2, K4, K5 and K5's
   backward by the schedule and no plain version, the plain rgb MSE
   falling; the eval battery inline over the predefined test split (K1 and
   K5 once per chunk; PSNR/SSIM, altitude MAE, semantic accuracy and mIoU);
21. ``quality_tools``: ``python -m satnerf_torch.tools.ours_train_eval``'s
   ``main`` at full width (8x512, 64 samples, 1,024 rays, bf16, the poly
   sine) on a generated 4 + 2-view 64x64 scene, 300 steps with curve evals
   at steps 100 and 200 and at the end: every results JSON's PSNR, SSIM,
   MAE, accuracy and mIoU finite, the test PSNR at the end above step
   100's, the launches of K1, K2, K4, K5 and K5's backward by the step and
   validation schedule plus K1 and K5 once per eval chunk, no plain
   version; ``tools.sin_swap_eval`` of that run under poly, poly5 and
   poly7f, each engine's renders through K1 under its ``SinMode``
   (``ops/field_fused.py:LAUNCHES_BY_SIN``); ``tools.quality_gate`` on the
   results JSON;
22. ``trained_audit``: the kernels against their plain versions at trained
   weights, where the checks above (at initial weights) do not reach: the
   field ``quality_tools`` trained, and one trained the same way in f32 for
   150 steps; one batch of their scene (1,024 rays + 1,024 depth rays, a
   fixed seed) at the run's step through the kernels and through their
   plain versions on the card (TF32 off), in f32 (3xTF32) and in bf16: every
   loss term, every output of K1 on the same points, K5's weights and the
   gradient of every parameter and of the t table, each within its bar
   (``TOL_AUDIT``); beside them, how far bf16 moves the kernels, their plain
   versions and the layer-by-layer field from the plain f32 step, how far
   the layer-by-layer f32 step is from it, and (the float64 column, no bar)
   how far the f32 kernels and their f32 plain versions lie from the plain
   step in f64 on the same batch; then the same at one hierarchical step
   (``HIER_AUDIT``: 64 + 128 samples, a fine field apart, ``remat_chunks``
   2) on that scene, the bf16 field as the coarse field and a perturbed
   warm start of it as the fine one: each field evaluation held against the
   plain version of its own field, every step at the f32 kernels' step's
   inverse-CDF depths; the phase's seconds, the hierarchical audit's apart;
23. ``bench``: ``satnerf_torch.bench.main(BENCH_MAIN_STEPS)`` at the JAX
   bench's default configuration (8,192 + 1,024 depth rays, bf16,
   ``sc_stride`` 2, a warm window and three of BENCH_MAIN_STEPS steps, each
   window one dispatch of that many replays of the captured step), in this
   process: its line, K1
   (both head variants), K2, K4, K5 and K5's backward launched as
   ``PER_STEP`` on every step, no plain version; one step of it at its own
   8,192 + 1,024 rays against the plain versions at ``TOL_AUDIT``'s bf16
   bars, with each side's peak device memory; and
   ``python -m satnerf_torch.bench`` as a user runs it (in full: windows of
   50 steps, the bench's own line);
24. ``bench_variants``: ``SATNERF_BENCH_HIER=128``, ``BWD=stored`` and
   ``SC_STRIDE=1`` at three steps a window, with the same checks at each
   one's own batch; the hierarchical one, whose fine points follow the
   coarse weights, call by call: each field evaluation and composite of
   one kernels' step replayed alone on its recorded inputs and upstream
   gradients through the kernels and the plain versions (and, no bar, the
   plain versions in f64);
25. ``tools``: ``tools.render_bench``, ``tools.speed_of_light`` (five passes
   a row, ``sc_stride`` 2) and ``tools.feed_rate`` through their ``main``:
   each line finite, the kernels launched by their renders and steps, none
   by the feed; then each phase group's seconds (``phase_seconds``).

K1's and K3's bounds are given three ways: f32 products as 3xTF32 on the
tensor cores (bound_ms in f32), on the f32 FMA units, and bf16 on the
tensor cores (bound_ms in bf16).

Then the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero. Without a GPU (or outside the repository) it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager as contextlib_contextmanager
from contextlib import nullcontext as contextlib_nullcontext

REPO = os.path.dirname(os.path.abspath(__file__))
PIPELINE_TOML = os.path.join(REPO, "configs", "pipelines", "rs_semantic.toml")

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # tf32 tensor cores (3xTF32 f32 products: 3 passes)
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12

# stated tolerances, kernel vs its plain version on the same card
TOL_SINE = 1e-6  # same arithmetic; only the Horner steps may contract (~1 ulp)
# raw pre-nonlinearity columns: in f32 the repo's bar between two field engines
# (tests/test_pallas_trunk.py:61). In bf16 both sides do the same arithmetic and
# differ only where a different f32 summation order flips the bf16 rounding of
# an activation; on an H100 that gave up to 7.4e-3 over 1,048,576 points, so
# the bar is 2e-2 (the 0.1 of :78 is for two different engines).
TOL_FIELD = {"float32": 5e-5, "bfloat16": 2e-2}
TOL_COMPOSITE = {"weights": 1e-6, "transparency": 1e-6, "depth": 1e-5, "rgb": 1e-5}
TOL_SERVE_CPU = {"rgb": 1e-4, "depth": 1e-4}  # served f32 outputs vs CPU plain path
# backward kernels vs their plain versions on the same residuals, max abs error
# over max |reference| per tensor. f32: the same f32 sums in another order
# (5.4e-6 read at 4,097 points); bf16: as TOL_FIELD, a one-ulp flip of a bf16
# activation (read 6.0e-3 at 4,097 points)
TOL_FIELD_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
# K1's residuals against the plain forward's, same measure: in bf16 a flipped
# activation (one ulp is 7.8e-3 at |h| ~ 1) feeds every later layer; read
# 1.46e-2 for the trunk output at 4,097 points
TOL_RESID = {"float32": 5e-5, "bfloat16": 4e-2}
TOL_COMPOSITE_BWD = {"sigmas": 1e-6, "albedo": 1e-5, "sun": 1e-6, "sky": 1e-6}
# a training step on the card against the same step on the CPU (f32): loss terms
# to 1e-4 of their value; updated params: Adam's first update is
# lr * g / (|g| + 1e-8), so an element whose gradient is float noise may move by
# up to 2 lr either way, every other element agrees to 2e-5 (see
# tests/test_torch_step.py); at most 0.1% of a tensor beyond 2e-5
TOL_STEP_LOSS = 1e-4
TOL_STEP_PARAM = 2e-5
# the same in bf16 (a bf16 compute_dtype: phase wide_widths, the TOML 768 and
# 1,024 wide): both sides round every activation to bf16, and where a
# different f32 sum flips one rounding the step and the image carry it. On
# an H100 (80GB HBM3, 700 W) the loss terms read up to 7.9e-5 (768) and
# 1.2e-5 (1,024) relative, the updated params beyond TOL_STEP_PARAM 0.24%
# and 0.35% of a tensor (none beyond 2 lr), the served rgb 2.3e-4 and depth
# 8.7e-5 abs over 128 rays. Bars: five times the loss reading, three times
# the share, 1e-3 served
TOL_STEP_BF16 = {"loss": 4e-4, "share": 1e-2}
TOL_SERVE_CPU_BF16 = {"rgb": 1e-3, "depth": 1e-3}
TOL_STORED = 1e-4  # "stored" vs "recompute" gradients, relative, f32
# phase widths: where K2 and its plain version recompute the sky head's ReLU
# pre-activation on two sides of 0 (its derivative is undefined there), the
# entry must lie within this share of the tensor's largest |pre-activation|:
# two f32 sums of the same three products differ by ~1e-7 of it
TOL_KINK = 1e-5
TRUNK_GRADS = ("gx", "w0", "w_mid", "w_skip", "b")  # trunk_backward's outputs, in order

# the beta_s ablation step against the CPU: as TOL_STEP_*; its plain heads run
# torch's own matmuls on both sides, so the same bars hold
N_FIELD_CHECK = 65_537  # ragged against the 64-row tile
# K1 and K3 against their plain versions around the 64-row tile, and ragged
FIELD_CHECK_POINTS = (1, 63, 64, 65, N_FIELD_CHECK)
TRAIN_RAYS = 1024  # configs/pipelines/rs_semantic.toml batch_size
TRAIN_STEPS = 5
CPU_STEP_RAYS = 32
LR = 5e-4  # rs_semantic.toml learnrate
# launches of each kernel per flagship training step: the main render (the
# all-heads and the solar-correction variants of K1) and the depth render
PER_STEP = {"field_fused": 3, "heads_bwd": 3, "trunk_fwd": 0, "trunk_bwd": 3,
            "composite": 2, "composite_bwd": 2, "trunk_fwd_interleaved": 0}
# Path A, the beta_s ablation field: K3 once per render over its main and
# solar-correction points together (main and depth renders), K4 once per K3,
# no K1 or K2 (the heads are plain PyTorch, as XLA code in the reference)
BETA_S = {"use_separate_beta_for_s": True, "use_beta_for_s": True}
PER_STEP_BETA_S = {"field_fused": 0, "heads_bwd": 0, "trunk_fwd": 2, "trunk_bwd": 2,
                   "composite": 2, "composite_bwd": 2, "trunk_fwd_interleaved": 0}
# Path B, the hierarchical configuration: the main render's coarse pass (64
# main + 32 solar-correction rungs) and fine pass (192 + 96), the depth
# render's coarse (64) and fine (192) passes: six halves, each evaluated in
# remat_chunks = 2 tiles, so 12 K1 launches forward and 12 more when the
# backward recomputes each tile; K2 and K4 once per tile; K5 and its backward
# once per pass
HIER = {"n_importance": 128, "use_fine_network": True, "remat_chunks": 2, "sc_stride": 2}
PER_STEP_HIER = {"field_fused": 24, "heads_bwd": 12, "trunk_fwd": 0, "trunk_bwd": 12,
                 "composite": 4, "composite_bwd": 4, "trunk_fwd_interleaved": 0}
TRUNK_TIME_POINTS = (65_536, 131_072)  # K3 per depth render / per main render
SERVE_COPIES = 8  # port_times: K1 at 8 x 131,072 = 1,048,576 points, the serve chunk
K6_POINTS, K6_C_IN = 1_048_576, 63  # tools/interleave_trunk_proto.py:82, :30
K6_CHECK_POINTS = (1, 63, 64, 65, 127, 128, 129, N_FIELD_CHECK)  # K6 against K3
# K3 and K6 in turns: f32 at K3's shapes and a serve chunk, bf16 at the prototype's
K6_TIME_SHAPES = (("float32", TRUNK_TIME_POINTS[0], "field"),
                  ("float32", TRUNK_TIME_POINTS[1], "field"),
                  ("float32", SERVE_COPIES * 131_072, "field"), ("bfloat16", K6_POINTS, "proto"))
# train_scene: the synthetic scene at generate_scene's defaults (4 + 1 views,
# 96 x 96, 300 tie points) trained for 4 epochs of 36 steps: the depth drop at
# step 36 and the beta gate at epoch 2 fall inside the run
SCENE = {"n_train": 4, "n_test": 1, "img_size": 96, "n_tie_points": 300}
SCENE_STEPS = 144
SCENE_STOP = 72  # run B stops here and resumes
SCENE_PIPELINE = PIPELINE_TOML
TOL_SCENE_SERVE = 1e-5  # served best vs the validation render of the same view
SERVE_H = SERVE_W = 128
N_REQUESTS = 3
CHUNK = 16_384
# train_dispatch: steps_per_dispatch K = 8 against K = 1 on the card. Each
# path's pipeline (the flagship TOML, Path A, Path B) on a 4 + 1-view 48 x 48
# scene (9 steps an epoch at 1,024 rays, 300 tie points) for 32 steps: the
# depth drop at 8, epoch ends at 9, 18 and 27, the beta gate at epoch 2
# (step 18); with log_every 100 the K = 8 blocks start at steps 0, 9 and 18
# (both variants replayed), the other steps are dispatched one at a time.
# Then the training CLI on train_scene's scene for one epoch (36 steps, the
# depth drop at 9, one validation), and K = 1 against K = 8 in turns at the
# flagship step config, the bench's and Path B's (train and train_hier's)
DISPATCH_K = 8
DISPATCH_SCENE = {"n_train": 4, "n_test": 1, "img_size": 48, "n_tie_points": 300}
DISPATCH_STEPS = 32
DISPATCH_PATHS = (("flagship", {}, PER_STEP), ("path_a", BETA_S, PER_STEP_BETA_S),
                  ("path_b", HIER, PER_STEP_HIER))
# a timed turn: as many eager steps, or one dispatch of replays
DISPATCH_TURN_STEPS = DISPATCH_K
# train_dp: one epoch of the scene (36 steps, the depth drop at its end) and
# its validation, over two gloo ranks on the one card against one process, at
# the JAX package's bars for its sharded step (tests/test_parallel.py)
DP_STEPS = 36
TOL_DP_LOSS, TOL_DP_PARAM = 2e-5, 1e-6
SWEEP_STEPS = 8  # each of the sweep's two runs, then its one validation
# prep_scene: a DFC2019 Track-3 distribution of the JAX_068 AOI with the 14
# views 000-013 (the predefined SatNeRF test views 002 and 012 among them) at
# 384 x 384, made into a dataset by the port's CLI and trained on for 200
# steps (the depth drop at 0.25 x 200 = 50; an epoch is ~1,700 steps, so the
# validations are the sanity one and the run's last)
PREP = {"n_views": 14, "img_size": 384, "n_tie_points": 300}
PREP_STEPS = 200
# quality_tools: ours_train_eval at full width (8 x 512, 64 samples, 1,024
# rays, bf16, the poly sine) on a 4 + 2-view 64 x 64 scene, QUALITY_STEPS
# steps (an epoch is 16 steps; the depth drop at 75) with curve evals at
# QUALITY_EVAL_AT and at the end, then sin_swap_eval and quality_gate
QUALITY_SCENE = {"n_train": 4, "n_test": 2, "img_size": 64, "n_tie_points": 300}
QUALITY_STEPS = 300
QUALITY_EVAL_AT = (100, 200)
QUALITY_SINS = ("poly", "poly5", "poly7f")
# trained_audit: the field quality_tools trained (bf16, QUALITY_STEPS) and one
# trained the same way in f32 for AUDIT_F32_STEPS; one batch of their scene
# (TRAIN_RAYS rays + TRAIN_RAYS depth rays, drawn and jittered from AUDIT_SEED)
# at the run's step through the kernels, against their plain versions on the
# card (the same autograd functions and packed weights, TF32 off), in f32 and in
# bf16: every loss term (TOL_STEP_LOSS's measure), every K1 output on the same
# points, K5's weights and every gradient (rel_err). f32: the bars of the kernel
# checks above (K1's outputs and K5's weights, which follow from them, at
# TOL_FIELD; the gradients at TOL_FIELD_BWD; the loss terms at TOL_STEP_LOSS).
# bf16: the same bf16 arithmetic on both sides, apart where an f32 sum in another
# order flips a bf16 rounding; read on an H100 80GB HBM3 (700 W) at the two fields up
# to 4.3e-6 on a loss term, 5.7e-3 on K1's outputs, 2.2e-4 on K5's weights and
# 1.04e-2 on a gradient (at the 256² rung's step 8,000: 7.5e-6, 1.9e-2, 2.0e-4,
# 1.65e-2), so the bars are TOL_STEP_LOSS, TOL_FIELD's and TOL_FIELD_BWD's bf16
# 2e-2 and 1e-3 for the weights, each under tests/test_pallas_trunk.py:78's 0.1
# between two engines. How far bf16 itself moves the step from
# the plain f32 one is printed beside, for the kernels and the plain versions
# alike, with no bar: at trained weights a head's gradient is a sum that nearly
# cancels, and a bf16 rounding of every point's terms moves it by up to its size.
# The float64 column (no bar): the f32 kernels and their f32 plain versions
# against the plain step in f64 (the same batch, jitter and points; every
# parameter in f64), so that the kernels' error and the yardstick's own are
# read apart
AUDIT_F32_STEPS = 150
# and one hierarchical step at the settings of the JAX package's hierarchical
# production run (tools/syn_long_run.py --n-importance 128 --use-fine-network),
# the bf16 run's field as the coarse field and, as the fine one, that field
# warm-started (train/checkpoint.py load_warm_start_params) and perturbed by
# seeded normals of HIER_AUDIT_PERTURB times each tensor's standard deviation,
# so that each fine evaluation is held against the fine field and not the coarse.
# Its f32 step is held to TOL_AUDIT throughout. Its bf16 gradients are held to the
# plain f32 step as well: on an H100 80GB HBM3 (700 W) bf16 moved the fine sun
# head's weight gradients by 25-27% of themselves in both engines (kernels 0.256,
# plain versions 0.250 on fine.sun_v_net.2.weight), and the two engines lay 3.7e-2
# to 4.7e-2 apart, over TOL_AUDIT's 2e-2 while each lay within 6e-5 of f64 in f32: so
# a bf16 gradient beyond its bar passes where the bf16 kernels are no farther from
# the plain f32 step than the plain bf16 step is, plus the bar (audit_failures)
HIER_AUDIT = {"n_importance": 128, "use_fine_network": True, "remat_chunks": 2}
HIER_AUDIT_PERTURB = 0.02
AUDIT_SEED = 7
AUDIT_LAYERED_TILES = 8  # the layer-by-layer field's checkpointed tiles (remat_chunks)
TOL_AUDIT = {
    "float32": {"loss": TOL_STEP_LOSS, "field": TOL_FIELD["float32"],
                "weights": TOL_FIELD["float32"], "grad": TOL_FIELD_BWD["float32"]},
    "bfloat16": {"loss": TOL_STEP_LOSS, "field": TOL_FIELD["bfloat16"], "weights": 1e-3,
                 "grad": TOL_FIELD_BWD["bfloat16"]},
}

# bench: the port's training-throughput bench (satnerf_torch/bench.py) at the JAX
# bench's default configuration in full (batch 8,192 + 1,024 depth rays, bf16,
# sc_stride 2: K1, K2, K4, K5 and its backward as PER_STEP, the solar-correction
# half on K1's heads-off variant) and, at BENCH_VARIANT_STEPS steps a window, three
# variants; each held against the plain versions at TOL_AUDIT["bfloat16"] at its
# own batch (bench_plain_check): a whole step on both sides (the same points), but
# for the hierarchical variant, whose fine points follow the coarse weights: there
# each field evaluation and composite of the kernels' step is replayed alone on
# its recorded inputs (bench_replay_check)
BENCH_VARIANTS = {"hier128": ({"SATNERF_BENCH_HIER": "128"}, PER_STEP_HIER),
                  "bwd_stored": ({"SATNERF_BENCH_BWD": "stored"}, PER_STEP),
                  "sc_stride1": ({"SATNERF_BENCH_SC_STRIDE": "1"}, PER_STEP)}
BENCH_VARIANT_STEPS = 3
# the in-process bench's steps a window (its launches counted): the CLI run
# after it measures the full 50-step windows, so 10 keep its checks and save
# 160 steps (~36 s on an H100) of the run's time
BENCH_MAIN_STEPS = 10
SOL_ARGS = ["--scan", "5", "--sc-stride", "2"]  # speed_of_light at the bench's stride
# phase widths: the (feat, feat_last) pairs of every trunk width the JAX kernels
# take below 512 (512 is the flagship's, checked above), at the rs_semantic TOML's
# 8 layers with its skip at 4: heads of half the width, or all of it
# (fc_use_full_features); 64 and 192 are not multiples of 128, so (128, 64) and
# (384, 192) run K3 and the heads layer by layer, as the JAX package does
WIDTH_PAIRS = ((128, 64), (128, 128), (256, 128), (256, 256), (384, 192), (384, 384))
WIDTH_POINTS = (1, 63, 65, 65_536)  # ragged against the 64-row tile, and a render's (timed)
# the four-scene workflow's training (satnerf_torch/tools/four_scenes.py at its
# defaults: 8 x 256, 32 samples, 2,048 rays, bf16, depth on, steps_per_dispatch
# 8) through the training CLI, on one of its scenes at a cut size
WIDTHS_SCENE = {"n_train": 6, "n_test": 2, "img_size": 64, "n_tie_points": 300}
WIDTHS_CLI_STEPS = 24
# the examples' field (satnerf_torch/examples/_common.py, the JAX package's
# 2 x 128) in the flagship step config: K3, K4 and K5 as on Path A
EXAMPLES_FIELD = {"fc_layers": 2, "fc_units": 128, "fc_skips": [1]}
# phase input_widths: encoded inputs past 64 wide at every trunk width, the
# rs_semantic TOML's 8 layers with its skip at 4 and heads K1 takes (half the
# width where that is a multiple of 128, else all of it): mapping_pos_n_freq 11,
# 12, 16 and 21 give c_in 66, 72, 96 and 126 (80, 80, 96 and 128 after padding
# to 16), every one inside the JAX kernels' c_in <= 128
INPUT_FREQS = (11, 12, 16, 21)
INPUT_POINTS = 65_536  # a training step's points
# the trunk widths phase input_widths crosses with INPUT_FREQS (those of PR
# 21's run; phase wide_widths takes the wider ones)
INPUT_FEAT_WIDTHS = (128, 256, 384, 512)
INPUT_TIME_FREQS = (10, 12, 21)  # device ms at 512 wide: c_in 60 beside 72 and 126
POSENC_FREQ = 12  # the JAX package's --posenc-freq lever (tools/syn_long_run.py:60-64)
# phase head_widths: (tau, n_classes) past the 16 aux and 16 output columns,
# to both of the JAX kernels' maxima (3 + 2 tau <= 128, 9 + n_classes <= 128),
# at 512 wide with both head widths and at one width below
HEAD_CASES = ((7, 8), (16, 12), (62, 119))
HEAD_PAIRS = ((512, 256), (512, 512), (256, 128))
HEAD_POINTS = 65_536
HEAD_STEP = {"t_embedding_tau": 16}  # the flagship step at 12 classes
HEAD_CLASSES = 12
HEAD_SCENE = {"n_train": 4, "n_test": 1, "img_size": 48, "n_tie_points": 300}
HEAD_CLI_STEPS = 18  # two epochs of the scene at the TOML's 1,024 rays
# port_times keys of K1-K4 (at 512), read in turns with the parent's
# phase wide_widths: trunks past 512 (the TOML's default heads, feat / 2:
# (768, 384) and (1,024, 512) run K1, (640, 320) and (896, 448) K3 with the
# heads layer by layer), K4 with 7 and 2 skips, the TOML trained and served
# at WIDE_STEP_UNITS and served at WIDE_K3_UNITS; the requests' first
# WIDE_CPU_RAYS rays against the CPU (its plain field at 1,024 wide takes
# about 10 s for 1,024 rays)
WIDE_PAIRS = ((640, 320), (768, 384), (896, 448), (1024, 512))
WIDE_POINTS = (1, 63, 65, 65_536)
WIDE_SKIPS = ((1, 2, 3, 4, 5, 6, 7), (2, 5))
WIDE_STEP_UNITS = (1024, 768)
WIDE_K3_UNITS = 640
WIDE_CPU_RAYS = 128
# head widths past 16 columns at the fused wide pairs (head_widths' cases
# with a 32- and a 128-wide output), each at 65,536 points
WIDE_HEAD_PAIRS = ((768, 384), (1024, 512))
WIDE_HEAD_CASES = ((16, 12), (62, 119))
WIDE_HEAD_POINTS = 65_536
PARENT_KERNEL_KEYS = ("field_fused", "field_fused_serve", "heads_bwd", "trunk_bwd_recompute",
                      "trunk_bwd_stored", "trunk_fwd")


def op_bounds(flops: float, dname: str) -> dict:
    """The ms that ``flops`` of work take at each engine's peak: f32 products
    as 3xTF32 on the tensor cores (three passes), on the f32 FMA units, and
    bf16 on the tensor cores; "ops_ms" is the one the kernel's dtype uses."""
    b = {"bound_3xtf32_ms": 3.0 * flops / PEAK_TF32_FLOPS * 1e3,
         "bound_f32_fma_ms": flops / PEAK_F32_FLOPS * 1e3,
         "bound_bf16_ms": flops / PEAK_BF16_FLOPS * 1e3}
    b["ops_ms"] = b["bound_3xtf32_ms"] if dname == "float32" else b["bound_bf16_ms"]
    return b


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    from satnerf_torch.device import card_line

    return card_line()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_CYCLES_PER_MS: list = []


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per device ms, read once."""
    import torch

    if not _CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        n = 20_000_000
        start.record()
        torch.cuda._sleep(n)
        end.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(n / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def device_time(fn, reps: int = 100, warmup: int = 3, repeats: int = 3) -> dict:
    """The device's ms per call of ``fn``, without the host's issue time.

    ``cuda_ms`` puts its events around calls as the host issues them, so a
    call whose host work outlasts its kernels times the host. Here the
    ``reps`` calls queue behind a ``torch.cuda._sleep`` that outlasts their
    issue (twice the plain loop's time, doubled until it covers the issue),
    so the events around them see back-to-back kernels: ``ms`` is the median
    of ``repeats`` such runs. Beside it: ``host_issue_us``, the least host
    clock per call over those queued loops, and ``host_loop_us``, the host
    clock per call over the plain loop with one synchronisation at the end.
    Keep reps x launches per call within the launch queue (a few hundred)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    cycles = 2.0 * loop_s * 1e3 * sleep_cycles_per_ms()
    runs, issues = [], []
    while len(runs) < repeats:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(cycles))
        ev[1].record()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_s = time.perf_counter() - t1
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.2 * issue_s * 1e3:
            runs.append(ev[1].elapsed_time(ev[2]) / reps)
            issues.append(issue_s / reps * 1e6)
        else:
            check(cycles < 2e10, f"device_time: no sleep covered the issue ({issue_s} s)")
            cycles *= 2
    return {"ms": sorted(runs)[len(runs) // 2], "host_issue_us": min(issues),
            "host_loop_us": loop_s / reps * 1e6}


def profiler_kernel_us(fn, pattern: str, reps: int = 30) -> float | None:
    """torch.profiler's self device µs per launch of the kernels whose name
    holds ``pattern``, over ``reps`` calls of ``fn`` (None: no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if pattern in ev.key and dev_us > 0:
            return dev_us / ev.count
    return None


# K5 at the main path's shapes: flagship and Path A training (64 samples), the
# Path B fine pass (64 + 128), a serve chunk, a Path B fine serve chunk
K5_SHAPES = ((1024, 64), (1024, 192), (CHUNK, 64), (CHUNK, 192))
# and ragged ones around the 32-lane warp and the lane runs, and rays past the
# forward's 256-sample segment (its carries) up to MAX_SAMPLES
K5_RAGGED = ((1001, 64), (77, 37), (33, 33), (1, 1), (1, 64), (7, 1), (1001, 300),
             (64, 1024))


def k5_bytes(b: int, s: int) -> tuple:
    """Bytes the forward and the backward must move: each input read once,
    each output written once. Forward: sigma, z, albedo, sun (B, S) and sky
    (B, 3) in; w, T (B, S), depth, rgb out. Backward: the forward's inputs
    and the four outputs' gradients in; the gradients of sigma, albedo, sun
    and sky out (the residuals a kernel reads are its design, not the
    function's)."""
    fwd = 4 * (6 * b * s + 3 * b) + 4 * (2 * b * s + 4 * b)
    bwd = 4 * (6 * b * s + 3 * b + 2 * b * s + 4 * b) + 4 * (5 * b * s + 3 * b)
    return fwd, bwd


def k5_inputs(b: int, s: int, seed: int, dev):
    """Seeded K5 inputs (sigma, z, albedo, sun, sky), some densities <= 0,
    with sun and sky as the renderer passes them: ``sun_v[..., 0]`` of a
    (B, S, 1) tensor and ``sky[:, 0, :]`` of a (B, S, 3) one (row stride 3S)."""
    import torch

    gc = torch.Generator().manual_seed(seed)
    sig = torch.rand(b, s, generator=gc) * 6 - 1
    z = torch.sort(torch.rand(b, s, generator=gc) * 2, dim=1).values
    alb = torch.rand(b, s, 3, generator=gc)
    sun = torch.rand(b, s, 1, generator=gc)
    sky = torch.rand(b, 1, 3, generator=gc).expand(b, s, 3).contiguous()
    sig, z, alb, sun, sky = (t.to(dev) for t in (sig, z, alb, sun, sky))
    return [sig, z, alb, sun[..., 0], sky[:, 0, :]]


L2_BYTES = 50e6  # H100 L2


def k5_calls(comp, b: int, s: int, dev) -> dict:
    """Callables for K5 at (b, s), each cycling over enough copies of its
    inputs (3x the L2) that every call reads them from device memory, as the
    main path does: "composite" the forward on contiguous inputs (the
    kernel), "composite_call" the forward with the renderer's strided sun/sky
    views (any copy included), "composite_bwd" the backward kernel's wrapper
    (with the residuals each slice's backward takes)."""
    import inspect
    import itertools

    import torch

    ins = k5_inputs(b, s, 7 + s, dev)
    gc = torch.Generator().manual_seed(b + s)
    cots = [torch.randn(shape, generator=gc).to(dev)
            for shape in ((b, s), (b, s), (b,), (b, 3))]
    with torch.no_grad():
        flat = [t.contiguous() for t in ins]
        if "rgb_pre" in inspect.signature(comp.composite_backward).parameters:
            _, t, _, _, pre = comp._forward_cuda(*flat, resid=True)
            res = [t, pre]
        else:  # the older backward takes the weights and the transparency
            res = list(comp.composite(*flat)[:2])
    # the forward reads 24 bytes a sample: the copies' reads span 3x the L2
    copies = math.ceil(3 * L2_BYTES / (24 * b * s))
    sets = [(ins, flat, res, cots)] + [
        ([t.clone() for t in ins[:4]]
         + [ins[4][:, None, :].expand(b, s, 3).contiguous()[:, 0, :]],  # as k5_inputs
         [t.clone() for t in flat], [t.clone() for t in res], [t.clone() for t in cots])
        for _ in range(copies - 1)]

    def cycle(make):
        it = itertools.cycle([make(*st) for st in sets])
        return lambda: next(it)()

    return {"composite": cycle(lambda i, f, r, c: lambda: comp.composite(*f)),
            "composite_call": cycle(lambda i, f, r, c: lambda: comp.composite(*i)),
            "composite_bwd": cycle(
                lambda i, f, r, c: lambda: comp.composite_backward(f, *r, *c)),
            "copies": copies}


def composite_times(dev, reps: int = 100) -> dict:
    """Device times (``device_time``) of K5 and its backward at K5_SHAPES,
    with the host's issue µs, inputs read from device memory (k5_calls):
    "composite/BxS" the forward kernel, with ``call_ms``/``call_host_issue_us``
    for a call on the renderer's strided sun/sky views;
    "composite_bwd/BxS" the backward. It calls only entry points every slice
    has, so ``--tree`` runs it on an older checkout too."""
    import torch

    from satnerf_torch.ops import composite as comp

    out = {}
    with torch.no_grad():
        for b, s in K5_SHAPES:
            calls = k5_calls(comp, b, s, dev)
            fwd = device_time(calls["composite"], reps)
            call = device_time(calls["composite_call"], reps)
            fwd.update(call_ms=call["ms"], call_host_issue_us=call["host_issue_us"],
                       input_copies=calls["copies"])
            out[f"composite/{b}x{s}"] = fwd
            out[f"composite_bwd/{b}x{s}"] = device_time(calls["composite_bwd"], reps)
            del calls
    return out


def synthetic_rays(n: int, seed: int, vocab: int):
    """Origins above the unit cube, near-nadir directions, near 0, far 2,
    one sun direction and one ts per request."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), np.ones((n, 1))], axis=1)
    d = np.concatenate([rng.uniform(-0.15, 0.15, (n, 2)), -np.ones((n, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.zeros((n, 1)), np.full((n, 1), 2.0)], axis=1)
    sun = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 0.8])
    sun /= np.linalg.norm(sun)
    ts = rng.integers(0, vocab)
    extras = np.concatenate([np.tile(sun, (n, 1)), np.full((n, 1), ts)], axis=1)
    return rays.astype(np.float32), extras.astype(np.float32)



def rel_err(a, b) -> float:
    """max |a - b| over max |b|, taken in f64."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def abs_err(a, b) -> float:
    """max |a - b|, taken in f64."""
    return float((a.double() - b.double()).abs().max())


def field_backward_phase(field, fcfg, enc, sun_d, t_emb) -> dict:
    """K1's residuals, K2 and K4 against their plain versions at the flagship
    width, every dtype, head variant and trunk engine; each run twice."""
    import dataclasses

    import torch

    from satnerf_torch.models.field import fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    n = enc.shape[0]
    g_out = torch.randn(n, fused_field_spec(fcfg).out_w,
                        generator=torch.Generator().manual_seed(3))
    g_out = g_out.to(enc.device)
    cases = {}
    worst_rel = {"heads": 0.0, "trunk": 0.0}
    worst_abs = {"heads": 0.0, "trunk": 0.0}
    with torch.no_grad():
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            packed = field.packed(dt)
            for bwd in ("recompute", "stored"):
                for heads_on in (True, False):
                    spec = dataclasses.replace(fused_field_spec(fcfg), heads_on=heads_on,
                                               trunk_bwd=bwd)
                    x = ff.pack_x(spec, enc, dt)
                    aux = ff.pack_aux(spec, sun_d, t_emb, None, dt)
                    out, shared, acts = ff._forward(spec, x, aux, packed, resid=True)
                    runs = []
                    for _ in range(2):
                        h = ff.heads_backward(spec, shared, aux, g_out, packed)
                        t = trunk.trunk_backward(spec, x, packed, acts, h[0])
                        torch.cuda.synchronize()
                        runs.append({"g_shared": h[0], "g_aux": h[1], **h[2],
                                     **dict(zip(TRUNK_GRADS, t))})
                    bitwise = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
                    ro, rs, ra = ff._reference_forward(spec, x, aux, packed, True)
                    rh = ff.heads_backward_reference(spec, shared, aux, g_out, packed)
                    rt = trunk.trunk_backward_reference(spec, x, packed, acts, rh[0])
                    ref = {"g_shared": rh[0], "g_aux": rh[1], **rh[2],
                           **dict(zip(TRUNK_GRADS, rt))}
                    resid = {"out": rel_err(out, ro), "shared": rel_err(shared, rs)}
                    if acts is not None:
                        resid["acts"] = rel_err(acts, ra)
                    errs = {k: rel_err(runs[0][k], ref[k]) for k in ref}
                    key = f"{dname}/{bwd}/heads_{'on' if heads_on else 'off'}"
                    cases[key] = {"grad_rel_err": errs, "resid_rel_err": resid,
                                  "bitwise_repeat": bitwise}
                    check(bitwise, f"{key}: two runs differ")
                    for k, e in errs.items():
                        check(e <= TOL_FIELD_BWD[dname], f"{key} grad {k} err {e}")
                    for k, e in resid.items():
                        check(e <= TOL_RESID[dname], f"{key} residual {k} err {e}")
                    for k in ref:
                        part = "trunk" if k in TRUNK_GRADS else "heads"
                        worst_rel[part] = max(worst_rel[part], errs[k])
                        if dname == "float32":
                            worst_abs[part] = max(
                                worst_abs[part],
                                float((runs[0][k].float() - ref[k].float()).abs().max()))
                    del out, shared, acts, runs, ref, rh, rt
    emit({"phase": "field_backward_check", "n": n, "cases": cases,
          "tol": {"grad": TOL_FIELD_BWD, "resid": TOL_RESID}})
    return {"max_rel_err": worst_rel, "max_abs_err_f32": worst_abs}


def composite_backward_phase(dev) -> dict:
    """K5's backward against autograd through its plain version at the main
    path's shapes and ragged ones, with rays whose density is all <= 0 and
    sun/sky as the renderer's strided views of (B, S, 1) and (B, S, 3)
    leaves; two runs, and a run on contiguous copies, bit for bit equal."""
    import torch

    from satnerf_torch.ops import composite as comp

    errs = {}
    for b, s in K5_SHAPES + K5_RAGGED:
        ins = k5_inputs(b, s, 10 + b + s, dev)
        ins[0][:8] = -ins[0][:8].abs()
        gc = torch.Generator().manual_seed(b)
        cots = [torch.randn(shape, generator=gc).to(dev)
                for shape in ((b, s), (b, s), (b,), (b, 3))]

        def grads(fn, strided=True):
            sig, z, alb = (t.clone().requires_grad_(i != 1) for i, t in enumerate(ins[:3]))
            sun_b = ins[3].clone()[..., None].requires_grad_()
            sky_b = ins[4][:, None, :].expand(b, s, 3).clone().requires_grad_()
            sun, sky = sun_b[..., 0], sky_b[:, 0, :]
            if not strided:
                sun, sky = sun.contiguous(), sky.contiguous()
            torch.autograd.backward(fn(sig, z, alb, sun, sky), cots)
            return [sig.grad, alb.grad, sun_b.grad[..., 0], sky_b.grad[:, 0, :]]

        got, again = grads(comp.composite), grads(comp.composite)
        flat = grads(comp.composite, strided=False)
        torch.cuda.synchronize()
        ref = grads(comp.composite_reference)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"composite backward {b}x{s}: two runs differ")
        check(all(torch.equal(a, c) for a, c in zip(got, flat)),
              f"composite backward {b}x{s}: strided and contiguous inputs differ")
        check(bool(torch.all(got[0][:8] == 0)), "sigma <= 0 rays got a gradient")
        e = {n: float((a - r).abs().max())
             for n, a, r in zip(("sigmas", "albedo", "sun", "sky"), got, ref)}
        errs[f"{b}x{s}"] = e
        for n, v in e.items():
            check(v <= TOL_COMPOSITE_BWD[n], f"composite backward {b}x{s} {n} {v}")
    emit({"phase": "composite_backward_check", "max_abs_err": errs, "bitwise_repeat": True,
          "strided_sun_sky": True, "tol": TOL_COMPOSITE_BWD})
    return errs


def composite_device_phase(turns: list | None, k5: dict) -> dict:
    """K5 and its backward at K5_SHAPES: device ms (``device_time``) of this
    tree and, with ``turns``, the parent's in turns (parent, this, this,
    parent); host issue µs per call; the card's launch floor (an empty
    kernel, ``torch.cuda._sleep(0)``, timed the same way); the byte bound and
    the share of it reached; torch.profiler's self device time of this
    tree's kernels beside the helper's."""
    import torch

    from satnerf_torch.ops import composite as comp

    dev = torch.device("cuda")
    floor = device_time(lambda: torch.cuda._sleep(0), reps=200)
    mine = theirs = None
    if turns:
        mine, theirs = turn_means(turns)
    rows, prof = {}, {}
    for b, s in K5_SHAPES:
        calls = k5_calls(comp, b, s, dev)
        for name, nbytes in zip(("composite", "composite_bwd"), k5_bytes(b, s)):
            key = f"{name}/{b}x{s}"
            here = k5[key]
            bound = nbytes / PEAK_HBM_BYTES * 1e3
            row = {"ms": here["ms"], "host_issue_us": here["host_issue_us"],
                   "host_loop_us": here["host_loop_us"], "bound_ms": bound,
                   "bound_by": "bytes", "share_of_bound": bound / here["ms"],
                   "over_launch_floor": here["ms"] / floor["ms"]}
            if name == "composite":
                row.update(call_ms=here["call_ms"], call_host_issue_us=here["call_host_issue_us"])
            if turns:
                row.update(
                    this_turns_ms=[tr["times"][key]["ms"] for tr in turns[1:3]],
                    parent_turns_ms=[tr["times"][key]["ms"] for tr in (turns[0], turns[3])],
                    this_mean_ms=mine[key], parent_ms=theirs[key],
                    parent_host_issue_us=[tr["times"][key]["host_issue_us"]
                                          for tr in (turns[0], turns[3])])
                if name == "composite":
                    row["parent_call_ms"] = [tr["times"][key]["call_ms"]
                                             for tr in (turns[0], turns[3])]
            pattern = "composite_backward_kernel" if name == "composite_bwd" else "composite_kernel"
            p_us = profiler_kernel_us(calls[name], pattern)
            prof[key] = p_us
            if p_us is not None:
                row["profiler_us"] = p_us
                # the events span back-to-back launches: never below the kernels
                check(here["ms"] * 1e3 >= 0.9 * p_us,
                      f"{key}: device_time {here['ms']} ms below the profiler's {p_us} us")
            rows[key] = row
        del calls
    line = {"phase": "composite_device_times", "nvidia_smi": smi_line(),
            "launch_floor_ms": floor["ms"], "launch_floor_host_issue_us": floor["host_issue_us"],
            "sleep_cycles_per_ms": sleep_cycles_per_ms(), "rows": rows,
            "profiler_us": prof}
    emit(line)
    return line


def train_batch(n: int, n_depth: int, seed: int, vocab: int, device,
                n_classes: int = 5) -> dict:
    """A seeded synthetic batch with every key a flagship step reads, its
    labels drawn over ``n_classes`` classes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), np.ones((n, 1))], axis=1)
    d = np.concatenate([rng.uniform(-0.15, 0.15, (n, 2)), -np.ones((n, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.zeros((n, 1)), np.full((n, 1), 2.0)], axis=1)
    sun = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.full((n, 1), 0.8)], axis=1)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    extras = np.concatenate([sun, rng.integers(0, vocab, (n, 1))], axis=1)
    batch = {
        "rays": rays, "extras": extras,
        "rgbs": rng.uniform(0, 1, (n, 3)),
        "semantic": rng.integers(0, n_classes, (n, 1)),
        "semantic_sparsity_mask": rng.uniform(size=n) > 0.1,
        "depth_rays": rays[:n_depth], "depth_extras": extras[:n_depth],
        "depth_depths": rng.uniform(0.5, 1.5, (n_depth,)),
        "depth_weights": rng.uniform(0.5, 1.0, (n_depth,)),
    }
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if t.is_floating_point():
            t = t.float()
        out[k] = t.to(device)
    return out


def copy_params(params: dict, device) -> dict:
    """Leaf copies of a params dict on ``device``."""
    from satnerf_torch.models.field import Field

    out = {}
    for key in ("field", "fine"):
        if params.get(key) is not None:
            field = Field(params[key].cfg)
            field.load_state_dict({k: v.detach().cpu()
                                   for k, v in params[key].state_dict().items()})
            out[key] = field.to(device)
    for k in ("t", "t_s"):
        if params.get(k) is not None:
            out[k] = params[k].detach().clone().to(device).requires_grad_(True)
    return out


def param_diff(a: dict, b: dict) -> dict:
    """Per tensor: max |a - b| and the share of elements beyond TOL_STEP_PARAM."""
    sa, sb = {}, {}
    for key in ("field", "fine"):
        if a.get(key) is not None:
            sa.update({f"{key}.{k}": v.detach().cpu() for k, v in a[key].state_dict().items()})
            sb.update({f"{key}.{k}": v.detach().cpu() for k, v in b[key].state_dict().items()})
    sa["t"], sb["t"] = a["t"].detach().cpu(), b["t"].detach().cpu()
    out = {}
    for k in sa:
        d = (sa[k] - sb[k]).abs()
        out[k] = (float(d.max()), float((d > TOL_STEP_PARAM).float().mean()))
    return out


def kernel_counters():
    """({kernel: (module, launch counter)}, {plain version: (module, counter)});
    ``field_trunk`` is the field's layer-by-layer trunk."""
    from satnerf_torch.models import field as fld
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    launches = {"field_fused": (ff, "LAUNCHES"), "heads_bwd": (ff, "HEADS_BWD_LAUNCHES"),
                "trunk_fwd": (trunk, "FWD_LAUNCHES"), "trunk_bwd": (trunk, "LAUNCHES"),
                "composite": (comp, "LAUNCHES"), "composite_bwd": (comp, "BWD_LAUNCHES"),
                "trunk_fwd_interleaved": (trunk, "INTERLEAVED_LAUNCHES")}
    plain = {"field_fused": (ff, "PLAIN_CALLS"), "trunk_fwd": (trunk, "FWD_PLAIN_CALLS"),
             "trunk_bwd": (trunk, "PLAIN_CALLS"), "composite": (comp, "PLAIN_CALLS"),
             "field_trunk": (fld, "PLAIN_CALLS")}
    return launches, plain


def reset_counters() -> None:
    import torch

    torch.cuda.synchronize()
    launches, plain = kernel_counters()
    for mod, name in list(launches.values()) + list(plain.values()):
        setattr(mod, name, 0)


def read_counters() -> tuple:
    launches, plain = kernel_counters()
    return ({k: getattr(mod, name) for k, (mod, name) in launches.items()},
            {k: getattr(mod, name) for k, (mod, name) in plain.items()})


OPEN_COUNTS: list = []  # the counts of the k1_variants blocks open now


def _count_cells() -> list:
    """(container, key) of every count that a training step moves: the
    launch and plain-call counters, TC_PREPARATIONS, K1's launches by
    SinMode and those of the open k1_variants blocks."""
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    launches, plain = kernel_counters()
    cells = [(vars(mod), name) for mod, name in list(launches.values()) + list(plain.values())]
    cells.append((vars(trunk), "TC_PREPARATIONS"))
    cells += [(ff.LAUNCHES_BY_SIN, k) for k in ff.LAUNCHES_BY_SIN]
    return cells + [(d, k) for d in OPEN_COUNTS for k in d]


def count_replays() -> None:
    """Count a replayed step (``train/dispatch.py:StepGraph``) as the
    launches captured for one step, times the replays: the capture gives back
    what its one step counted (nothing ran), and each replay adds it to every
    count (``step_counts`` of the graph: {count: per step})."""
    from satnerf_torch.train import dispatch

    cls = dispatch.StepGraph
    if getattr(cls, "counted_by_replay", False):
        return
    capture, step = cls.capture, cls.step

    def counted_capture(self):
        cells = _count_cells()
        before = [c[k] for c, k in cells]
        capture(self)
        self.step_counts = [(c, k, c[k] - b) for (c, k), b in zip(cells, before) if c[k] != b]
        for c, k, d in self.step_counts:
            c[k] -= d

    def counted_step(self, seed=None):
        out = step(self, seed)
        for c, k, d in self.step_counts:
            c[k] += d
        return out

    cls.capture, cls.step, cls.counted_by_replay = counted_capture, counted_step, True


def captured_launches(graph) -> dict:
    """A captured step's launches by kernel (count_replays' ``step_counts``)."""
    from satnerf_torch.ops import trunk

    launches, _ = kernel_counters()
    by_cell = {(id(c), k): d for c, k, d in graph.step_counts}
    out = {name: by_cell.get((id(vars(mod)), attr), 0) for name, (mod, attr) in launches.items()}
    out["preparations"] = by_cell.get((id(vars(trunk)), "TC_PREPARATIONS"), 0)
    return out


def train_phase(dev, vocab: int, name: str = "train", overrides: dict | None = None,
                per_step: dict = PER_STEP, stored_check: bool = True,
                preparations: int = 1, n_classes: int = 5) -> dict:
    """Five training steps of the flagship step config (with ``overrides``
    of its pipeline keys, ``n_classes`` semantic classes) through the
    kernels, each preparing the K1/K3 weights ``preparations`` times (once
    per field), then a 32-ray step against the CPU plain path (in bf16 at
    TOL_STEP_BF16's bars) and, with ``stored_check``, a "stored"-engine
    step."""
    import dataclasses
    import math

    import torch

    from satnerf_torch.configs import load_pipeline_toml, step_config_from_pipeline
    from satnerf_torch.ops import trunk
    from satnerf_torch.train.state import create_train_state, init_params, trainable
    from satnerf_torch.train.step import build_train_step

    p = load_pipeline_toml(PIPELINE_TOML)
    p.update(trunk_impl="pallas", **(overrides or {}))
    scfg = step_config_from_pipeline(p, steps_per_epoch=1000, n_classes=n_classes,
                                     car_index=4, device=dev)
    # as bench.py:257-260: every loss term on from step 0
    scfg = dataclasses.replace(scfg, use_car_reg_loss=True, car_reg_loss_start=0,
                               first_beta_epoch=0)
    check(scfg.depth and scfg.render.field.trunk_bwd == "recompute"
          and scfg.render.n_samples == 64, f"{name} step config")
    fine = scfg.render.use_fine_network
    params = init_params(torch.Generator().manual_seed(0), scfg.render.field,
                         t_vocab=vocab, device=dev, use_fine_network=fine)
    start = copy_params(params, "cpu")
    state = create_train_state(params, LR, "step", scfg.steps_per_epoch)
    step = build_train_step(scfg)
    batch = train_batch(TRAIN_RAYS, TRAIN_RAYS, 5, vocab, dev, n_classes)
    gen = torch.Generator(device=dev).manual_seed(0)

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, preps = [], [], []
    for _ in range(TRAIN_STEPS):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = trunk.TC_PREPARATIONS
        t0.record()
        state, metrics = step(state, batch, gen)
        t1.record()
        torch.cuda.synchronize()
        step_ms.append(t0.elapsed_time(t1))
        preps.append(trunk.TC_PREPARATIONS - before)
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()), f"non-finite metrics {vals}")
        losses.append(vals)
    got, plain_calls = read_counters()
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    check(got == want, f"{name} launches {got}, expected {want}")
    check(not any(plain_calls.values()), f"{name}: a plain version ran: {plain_calls}")
    check(preps == [preparations] * TRAIN_STEPS,
          f"{name}: K1/K3 weight preparations per step {preps}, expected {preparations}")
    if fine:
        c_keys = [k for k in losses[-1] if k.startswith("c_")]
        check(len(c_keys) >= 6, f"{name}: coarse loss terms {c_keys}")
    steady = step_ms[-3:]
    ms = sum(steady) / len(steady)
    emit({"phase": name, "overrides": overrides or {}, "steps": TRAIN_STEPS,
          "rays": TRAIN_RAYS,
          "depth_rays": TRAIN_RAYS, "step_ms": step_ms, "ms_per_step": ms,
          "rays_per_s": TRAIN_RAYS / (ms / 1e3), "launches": got,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in got.items()},
          "plain_calls": plain_calls, "preparations_per_step": preps,
          "metrics_first": losses[0],
          "metrics_last": losses[-1],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

    # one 32-ray step on the card and on CPU copies of the same params
    small = {k: v[:CPU_STEP_RAYS] for k, v in batch.items()}
    results = {}
    for where in ("cuda", "cpu"):
        dev_w = dev if where == "cuda" else torch.device("cpu")
        prm = copy_params(state.params, dev_w)
        st = create_train_state(prm, LR, "step", scfg.steps_per_epoch)
        st.step = state.step
        st, m = build_train_step(scfg)(st, {k: v.to(dev_w) for k, v in small.items()})
        results[where] = ({k: float(v) for k, v in m.items()}, st.params)
    loss_err = {k: abs(results["cuda"][0][k] - v) / max(1.0, abs(v))
                for k, v in results["cpu"][0].items()}
    pdiff = param_diff(results["cuda"][1], results["cpu"][1])
    tol = (TOL_STEP_BF16 if scfg.render.compute_dtype == "bfloat16"
           else {"loss": TOL_STEP_LOSS, "share": 1e-3})
    check(set(loss_err) == set(results["cuda"][0]), f"{name}: loss keys differ")
    for k, e in loss_err.items():
        check(e <= tol["loss"], f"{name} 32-ray step {k} card vs CPU {e}")
    for k, (mx, share) in pdiff.items():
        check(mx <= 2 * LR + 1e-6 and share <= tol["share"],
              f"{name} 32-ray step param {k}: {mx} {share}")
    check_line = {"phase": f"{name}_check", "cpu_step_rays": CPU_STEP_RAYS,
                  "loss_rel_err": loss_err,
                  "param_max_abs_err": max(v[0] for v in pdiff.values()),
                  "param_share_beyond_tol": max(v[1] for v in pdiff.values()),
                  "tol": {**tol, "param": TOL_STEP_PARAM}}
    if not stored_check:
        emit(check_line)
        return {"launches": got, "scfg": scfg, "params": state.params}

    # "stored" against "recompute" from the same params, deterministic ladder
    grads = {}
    for bwd in ("recompute", "stored"):
        sc = dataclasses.replace(scfg, render=dataclasses.replace(
            scfg.render, field=dataclasses.replace(scfg.render.field, trunk_bwd=bwd)))
        prm = copy_params(start, dev)
        st = create_train_state(prm, LR, "step", scfg.steps_per_epoch)
        st, m = build_train_step(sc)(st, batch)
        torch.cuda.synchronize()
        grads[bwd] = [p.grad.detach().clone() for p in trainable(st.params)]
        del st, prm
    stored_err = max(rel_err(a, b) for a, b in zip(grads["stored"], grads["recompute"]))
    stored_same = all(torch.equal(a, b) for a, b in zip(grads["stored"], grads["recompute"]))
    check(stored_err <= TOL_STORED, f"stored vs recompute gradients {stored_err}")
    check_line.update(stored_vs_recompute_grad_rel_err=stored_err,
                      stored_vs_recompute_bitwise=stored_same)
    check_line["tol"]["stored"] = TOL_STORED
    emit(check_line)
    return {"launches": got, "scfg": scfg, "params": state.params}


def train_times_phase(dev, scfg, params, turns: list | None, k5: dict) -> dict:
    """CUDA-event times of each kernel and its plain version at the shapes of
    one flagship training step (65,536 points, f32), with the bounds; K2 and
    K4 (f32 and bf16, split into row launches and reductions, with the
    parent's times in ``turns``) come from bwd_times; K5's device times from
    ``k5`` (composite_times)."""
    import torch

    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import fused_field_spec
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff

    fcfg = scfg.render.field
    n = TRAIN_RAYS * scfg.render.n_samples
    g = torch.Generator().manual_seed(11)
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1,
                              fcfg.mapping_pos_n_freq).to(dev)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(dev)
    te = torch.randn(n, fcfg.t_embedding_tau, generator=g).to(dev)
    dt, f4 = torch.float32, 4
    out = {}

    def entry(ms, plain_ms, flops, nbytes, shape):
        ops_ms = flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "flops": flops, "bytes": nbytes, "shape": shape}

    with torch.no_grad():
        packed = params["field"].packed(dt)
        w_bytes = sum(t.numel() * t.element_size() for t in packed.values())
        spec = fused_field_spec(fcfg)
        x = ff.pack_x(spec, enc, dt)
        aux = ff.pack_aux(spec, sun, te, None, dt)
        io = (x.numel() + aux.numel()) * f4
        k1 = cuda_ms(lambda: ff._forward(spec, x, aux, packed, True), reps=3)
        k1p = cuda_ms(lambda: ff._reference_forward(spec, x, aux, packed, True), reps=2)
        k1_flops = 2.0 * spec.mac_per_point() * n
        k1_bytes = io + w_bytes + n * (out_cols(spec) + spec.feat) * f4
        bounds = op_bounds(k1_flops, "float32")
        ops_ms = bounds.pop("ops_ms")
        bytes_ms = k1_bytes / PEAK_HBM_BYTES * 1e3
        out["field_fused"] = dict(
            entry(k1, k1p, k1_flops, k1_bytes, [n, spec.cx]), **bounds,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        del x, aux

    # compositing at the main render's shape: (1,024 rays, 64 samples)
    b, s = TRAIN_RAYS, scfg.render.n_samples
    gc = torch.Generator().manual_seed(12)
    ins = [torch.rand(b, s, generator=gc) * 6 - 1,
           torch.sort(torch.rand(b, s, generator=gc) * 2, dim=1).values,
           torch.rand(b, s, 3, generator=gc), torch.rand(b, s, generator=gc),
           torch.rand(b, 3, generator=gc)]
    ins = [t.to(dev) for t in ins]
    cots = [torch.randn(shape, generator=gc).to(dev)
            for shape in ((b, s), (b, s), (b,), (b, 3))]
    # the kernels' device times (composite_times); the plain versions' as a
    # caller sees them, host included
    cp_ms = cuda_ms(lambda: comp.composite_reference(*ins), reps=50, warmup=3)
    c_bytes, cb_bytes = k5_bytes(b, s)
    kf, kb = k5[f"composite/{b}x{s}"], k5[f"composite_bwd/{b}x{s}"]
    out["composite"] = dict(entry(kf["ms"], cp_ms, 25.0 * b * s, c_bytes, [b, s]),
                            host_issue_us=kf["host_issue_us"])
    leaves = [x.clone().requires_grad_(i != 1) for i, x in enumerate(ins)]
    ref_outs = comp.composite_reference(*leaves)
    kbp = cuda_ms(lambda: torch.autograd.grad(ref_outs, [leaves[i] for i in (0, 2, 3, 4)],
                                              cots, retain_graph=True), reps=50, warmup=3)
    out["composite_bwd"] = dict(entry(kb["ms"], kbp, 60.0 * b * s, cb_bytes, [b, s]),
                                host_issue_us=kb["host_issue_us"])
    bwd, extra = bwd_times(dev, turns)
    emit({"phase": "train_kernel_times", "dtype": "float32 (K2, K4: and bfloat16)",
          "times": {**out, **bwd}, **extra})
    return {**out, **bwd}


@contextlib_contextmanager
def timed_blocks(rec: list):
    """Record CUDA events around every row-GEMM launch and every reduction of
    K2 and K4 (the two helpers of ``ops/_bwd.py``) into ``rec``."""
    import torch

    from satnerf_torch.ops import _bwd

    saved = _bwd.row_op, _bwd.reduce_op

    def wrap(kind, fn):
        def call(*args, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args, **kw)
            e.record()
            rec.append((kind, s, e))
        return call

    _bwd.row_op, _bwd.reduce_op = wrap("row", saved[0]), wrap("reduce", saved[1])
    try:
        yield
    finally:
        _bwd.row_op, _bwd.reduce_op = saved


def out_cols(spec) -> int:
    """Columns of the packed raw output: ``spec.out_w``; 16 in a parent
    build from before the head widths (run by ``--tree``), whose FieldSpec
    has no out_w and whose output was always 16 wide."""
    return getattr(spec, "out_w", 16)


def flagship_case(dev, enc_copies: int = 1) -> dict:
    """The flagship field from seed 0 and seeded inputs at the training shape
    (65,536 points; ``enc_copies`` times as many encoded positions): the
    set-up port_times and bwd_times share."""
    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, fused_field_spec

    rcfg = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas")
    fcfg = rcfg.field
    n = TRAIN_RAYS * rcfg.n_samples
    g = torch.Generator().manual_seed(11)
    return {
        "fcfg": fcfg, "n": n,
        "field": Field(fcfg, generator=torch.Generator().manual_seed(0)).to(dev).eval(),
        "enc": positional_encoding(torch.rand(enc_copies * n, 3, generator=g) * 2 - 1,
                                   fcfg.mapping_pos_n_freq).to(dev),
        "sun": torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(dev),
        "te": torch.randn(n, fcfg.t_embedding_tau, generator=g).to(dev),
        "g_out": torch.randn(n, out_cols(fused_field_spec(fcfg)), generator=g).to(dev),
    }


def port_times(dev, save: str | None = None, reps: int = 3) -> dict:
    """CUDA-event times at the flagship training shapes of K2 and K4 (both
    engines; 65,536 points, f32 and bf16), each with its row-GEMM launches
    and its reductions summed apart, of K1 with residuals (65,536) and K3
    (131,072), and of K1 at the serve chunk (1,048,576 points), f32 and bf16,
    on a field from seed 0. With ``save``, the outputs of K1, K2, K3 and K4
    (both engines) go to that file. It calls only entry points that every slice of
    the port has, so ``--tree`` runs it on an older checkout too."""
    import dataclasses

    import torch

    from satnerf_torch.models.field import fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    case = flagship_case(dev, enc_copies=2)  # K3 runs on 131,072 points
    fcfg, field, n = case["fcfg"], case["field"], case["n"]
    enc, sun, te, g_out = (case[k] for k in ("enc", "sun", "te", "g_out"))

    def split(fn):
        ms = cuda_ms(fn, reps=reps)
        rec = []
        with timed_blocks(rec):
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
        row = [s.elapsed_time(e) for k, s, e in rec if k == "row"]
        red = [s.elapsed_time(e) for k, s, e in rec if k == "reduce"]
        return {"ms": ms, "row_ms": sum(row) / reps, "reduce_ms": sum(red) / reps,
                "row_launches": len(row) // reps, "reductions": len(red) // reps}

    out, saved = {}, {}
    with torch.no_grad():
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            packed = field.packed(dt)
            for bwd in ("recompute", "stored"):
                spec = dataclasses.replace(fused_field_spec(fcfg), trunk_bwd=bwd)
                x = ff.pack_x(spec, enc[:n], dt)
                aux = ff.pack_aux(spec, sun, te, None, dt)
                res = ff._forward(spec, x, aux, packed, resid=True)
                shared, acts = res[1], res[2]
                if bwd == "recompute":
                    saved[f"k1/{dname}"] = res[:2]
                    h = ff.heads_backward(spec, shared, aux, g_out, packed)
                    g_shared = h[0]
                    saved[f"k2/{dname}"] = [h[0], h[1], *h[2].values()]
                    out[f"heads_bwd/{dname}"] = split(
                        lambda: ff.heads_backward(spec, shared, aux, g_out, packed))
                    out[f"field_fused/{dname}"] = {"ms": cuda_ms(
                        lambda: ff._forward(spec, x, aux, packed, True), reps=reps)}
                saved[f"k4_{bwd}/{dname}"] = list(
                    trunk.trunk_backward(spec, x, packed, acts, g_shared))
                out[f"trunk_bwd_{bwd}/{dname}"] = split(
                    lambda: trunk.trunk_backward(spec, x, packed, acts, g_shared,
                                                 need_gx=False))
                del res, shared, acts
        spec = fused_field_spec(fcfg)
        out.update(block_times(dev, n))
        out.update(bwd_width_times(dev, n))
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            packed = field.packed(dt)
            x2 = ff.pack_x(spec, enc, dt)
            saved[f"k3/{dname}"] = trunk._forward(spec, x2, packed, True)
            out[f"trunk_fwd/{dname}"] = {"ms": cuda_ms(
                lambda: trunk._forward(spec, x2, packed, False), reps=reps)}
            # K1 at the serve chunk's 1,048,576 points, no residuals
            xs = ff.pack_x(spec, enc.repeat(SERVE_COPIES, 1), dt)
            auxs = ff.pack_aux(spec, sun.repeat(2 * SERVE_COPIES, 1),
                               te.repeat(2 * SERVE_COPIES, 1), None, dt)
            out[f"field_fused_serve/{dname}"] = {"ms": cuda_ms(
                lambda: ff._forward(spec, xs, auxs, packed, False), reps=reps)}
            del x2, xs, auxs
    if save:
        torch.save({k: [t.cpu() for t in v] for k, v in saved.items()}, save)
    return out


BLOCK_WIDTH = 512  # the building blocks alone: n x 512 x 512 products (bwd_times' yardsticks)
BWD_TURN_PAIRS = ((256, 128), (1024, 512))  # K2 and K4 beside the flagship's, in turns


def bwd_width_times(dev, n: int) -> dict:
    """Device ms (``device_time``) of K2 and K4 ("recompute") at the
    rs_semantic TOML's depth and the (feat, feat_last) of BWD_TURN_PAIRS
    (the four-scene workflow's 256 x 128, the widest 1,024 x 512), f32 and
    bf16, at n points, on seed-0 weights: {"heads_bwd@256x128/float32":
    {"ms"}, ...}. Entry points every slice with trunks to 1,024 wide has, so ``--tree``
    runs it on an older checkout too."""
    import dataclasses

    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    out = {}
    for feat, fl in BWD_TURN_PAIRS:
        fcfg = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas", fc_units=feat,
                                  fc_use_full_features=fl == feat).field
        field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
        spec = dataclasses.replace(fused_field_spec(fcfg), trunk_bwd="recompute")
        g = torch.Generator().manual_seed(11)
        enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1,
                                  fcfg.mapping_pos_n_freq).to(dev)
        sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(dev)
        te = torch.randn(n, fcfg.t_embedding_tau, generator=g).to(dev)
        g_out = torch.randn(n, out_cols(spec), generator=g).to(dev)
        with torch.no_grad():
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                packed = field.packed(dt)
                x = ff.pack_x(spec, enc, dt)
                aux = ff.pack_aux(spec, sun, te, None, dt)
                shared = ff._forward(spec, x, aux, packed, resid=True)[1]
                g_shared = ff.heads_backward(spec, shared, aux, g_out, packed)[0]
                key = f"@{feat}x{fl}/{dname}"
                out["heads_bwd" + key] = {"ms": device_time(
                    lambda: ff.heads_backward(spec, shared, aux, g_out, packed), reps=2,
                    warmup=1)["ms"]}
                out["trunk_bwd_recompute" + key] = {"ms": device_time(
                    lambda: trunk.trunk_backward(spec, x, packed, None, g_shared, need_gx=False),
                    reps=2, warmup=1)["ms"]}
                del shared, g_shared
        del field
        torch.cuda.empty_cache()
    return out


def block_times(dev, n: int, reps: int = 10) -> dict:
    """CUDA-event ms of each building block of K2 and K4 alone at the
    yardstick shapes, f32 and bf16: one row_op (A (n, 512) @ W (512, 512),
    out in the compute dtype) and one reduce_op (A^T B, both (n, 512)), the
    weight prepared once beforehand as the wrappers prepare it (a
    ``row_weight``, or in an older checkout its tf32 split). ``ops/_bwd.py``
    entry points only, so ``--tree`` runs it on an older checkout too."""
    import torch

    from satnerf_torch.ops import _bwd

    g = torch.Generator().manual_seed(5)
    times = {}
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        a, b = (torch.randn(n, BLOCK_WIDTH, generator=g).to(dev).to(dt) for _ in range(2))
        wt = torch.randn(BLOCK_WIDTH, BLOCK_WIDTH, generator=g).to(dev).to(dt)
        if hasattr(_bwd, "row_weight"):
            w = _bwd.row_weight(wt, dt)
        else:
            w = _bwd.tf32_split(wt) if dt == torch.float32 else wt
        res = torch.empty((n, BLOCK_WIDTH), dtype=dt, device=dev)
        gw = torch.empty((BLOCK_WIDTH, BLOCK_WIDTH), dtype=torch.float32, device=dev)
        times[f"row_block/{dname}"] = {"ms": cuda_ms(lambda: _bwd.row_op(
            "trunk_bwd", "trunk_bwd_row", dt, n, BLOCK_WIDTH, prods=[(a, w)], out_dt=res),
            reps=reps, warmup=2)}
        times[f"reduce_block/{dname}"] = {"ms": cuda_ms(lambda: _bwd.reduce_op(
            "trunk_bwd", "trunk_bwd_reduce", dt, n, gemms=[(a, b, gw)]), reps=reps, warmup=2)}
        del a, b, wt, w, res, gw
    return times


def run_turns(parent: str) -> list:
    """child_times on the checkout ``parent`` and on this one in turns
    (parent, this, this, parent), each in its own process: [{"tree", "times"}]."""
    outdir = os.path.join(REPO, "build", "turns")
    os.makedirs(outdir, exist_ok=True)
    turns = []
    for i, tree in enumerate((parent, REPO, REPO, parent)):
        path = os.path.join(outdir, f"turn{i}.pt")
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                              os.path.abspath(tree), "--save", path],
                             capture_output=True, text=True, timeout=900)
        check(res.returncode == 0, f"turn {i} in {tree}: {res.stderr[-2000:]}")
        lines = res.stdout.strip().splitlines()
        build = [json.loads(x)["child_build"] for x in lines if x.startswith('{"child_build"')]
        turns.append({"tree": "parent" if tree == parent else "this",
                      "times": json.loads(lines[-1]), "build": build[0] if build else None})
    return turns


def turn_means(turns: list) -> tuple:
    """({key: this tree's mean ms}, {key: the parent's mean ms}) over the turns."""
    mine = {k: sum(t["times"][k]["ms"] for t in turns[1:3]) / 2 for k in turns[1]["times"]}
    theirs = {k: sum(t["times"][k]["ms"] for t in (turns[0], turns[3])) / 2
              for k in turns[0]["times"]}
    return mine, theirs


def bwd_times(dev, turns: list | None) -> tuple:
    """({key: entry}, extra fields): K2's and K4's times (port_times) beside
    their bounds, their plain versions' times and one torch.matmul of each
    building block's product shape; with ``turns`` (run_turns against an
    older checkout), that tree's times in turns, and K1's and K3's f32
    outputs held against the parent's within the field bars (whether they are
    bit for bit equal is printed). ``forward_times``: K1's and K3's times
    from the same turns."""
    import dataclasses

    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models.field import fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    parent = bool(turns)
    bitwise, vs_parent = None, None
    if parent:
        outdir = os.path.join(REPO, "build", "turns")
        a, b = (torch.load(os.path.join(outdir, f"turn{i}.pt")) for i in (0, 1))
        bitwise = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a}
        # the engine changed (FMA -> tensor cores): K1/K3 against the parent's
        # f32 outputs within the bars against the plain version, out in abs,
        # the residual (h_{L-1} or the pre-activations) relative
        vs_parent = {}
        for k in ("k1/float32", "k3/float32"):
            if k in a:
                vs_parent[k] = {"out": float((b[k][0].float() - a[k][0].float()).abs().max()),
                                "resid": rel_err(b[k][1], a[k][1])}
                check(vs_parent[k]["out"] <= TOL_FIELD["float32"]
                      and vs_parent[k]["resid"] <= TOL_RESID["float32"],
                      f"{k} differs from the parent's: {vs_parent[k]}")
        mine, theirs = turn_means(turns)
    times = turns[1]["times"] if parent else port_times(dev)

    case = flagship_case(dev)
    fcfg, field, n = case["fcfg"], case["field"], case["n"]
    enc, sun, te, g_out = (case[k] for k in ("enc", "sun", "te", "g_out"))
    plain = {}
    with torch.no_grad():
        packed = field.packed(torch.float32)
        for bwd in ("recompute", "stored"):
            spec = dataclasses.replace(fused_field_spec(fcfg), trunk_bwd=bwd)
            x = ff.pack_x(spec, enc, torch.float32)
            aux = ff.pack_aux(spec, sun, te, None, torch.float32)
            _, shared, acts = ff._forward(spec, x, aux, packed, resid=True)
            if bwd == "recompute":
                g_shared = ff.heads_backward_reference(spec, shared, aux, g_out, packed)[0]
                plain["heads_bwd"] = cuda_ms(lambda: ff.heads_backward_reference(
                    spec, shared, aux, g_out, packed), reps=2)
            plain[f"trunk_bwd_{bwd}"] = cuda_ms(lambda: trunk.trunk_backward_reference(
                spec, x, packed, acts, g_shared), reps=2)
            del shared, acts

    # one torch.matmul of each building block's product, as a yardstick only
    yard = {}
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        a = torch.randn(n, 512, device=dev).to(dt)
        w = torch.randn(512, 512, device=dev).to(dt)
        with_prec = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        yard[f"row_{n}x512x512/{dname}"] = cuda_ms(lambda: torch.matmul(a, w), reps=20, warmup=3)
        yard[f"reduce_512x{n}x512/{dname}"] = cuda_ms(lambda: torch.matmul(a.t(), a),
                                                      reps=20, warmup=3)
        torch.set_float32_matmul_precision(with_prec)
        del a, w

    spec = fused_field_spec(fcfg)
    f4 = 4
    entries = {}
    # the building blocks alone beside their bounds and the torch.matmul yardsticks
    for dname in ("float32", "bfloat16"):
        esz = f4 if dname == "float32" else 2
        flops = 2.0 * n * BLOCK_WIDTH * BLOCK_WIDTH
        tc_ms = (3.0 * flops / PEAK_TF32_FLOPS if dname == "float32"
                 else flops / PEAK_BF16_FLOPS) * 1e3
        for kind, nbytes, yk in (
                ("row_block", (2 * n + BLOCK_WIDTH) * BLOCK_WIDTH * esz, f"row_{n}x512x512"),
                ("reduce_block", 2 * n * BLOCK_WIDTH * esz + BLOCK_WIDTH ** 2 * f4,
                 f"reduce_512x{n}x512")):
            key = f"{kind}/{dname}"
            bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
            e = {"ms": mine[key] if parent else times[key]["ms"],
                 "bound_ms": max(tc_ms, bytes_ms),
                 "bound_by": "operations" if tc_ms >= bytes_ms else "bytes",
                 "library_ms": yard[f"{yk}/{dname}"], "shape": [n, BLOCK_WIDTH, BLOCK_WIDTH]}
            if parent and key in theirs:
                e["parent_ms"] = theirs[key]
                e["turns_ms"] = [tr["times"][key]["ms"] for tr in turns if key in tr["times"]]
            entries[key] = e
    for key, macs in (("heads_bwd", spec.heads_bwd_mac_per_point()),
                      ("trunk_bwd_recompute", dataclasses.replace(
                          spec, trunk_bwd="recompute").trunk_bwd_mac_per_point()),
                      ("trunk_bwd_stored", dataclasses.replace(
                          spec, trunk_bwd="stored").trunk_bwd_mac_per_point())):
        flops = 2.0 * macs * n
        for dname in ("float32", "bfloat16"):
            esz = f4 if dname == "float32" else 2
            if key == "heads_bwd":  # shared, aux, g in; g_shared, g_aux, head grads out
                nbytes = n * (2 * spec.feat + 2 * spec.aux_w) * esz + n * spec.out_w * f4 \
                    + 2 * sum(packed[k].numel() for k in spec.head_keys()) * f4
            else:  # x, g_shared (and the stored pre-activations) in; gradients out
                nbytes = n * (spec.cx + spec.feat) * esz + 2 * sum(
                    packed[k].numel() for k in ff.TRUNK_KEYS) * f4
                if key.endswith("stored"):
                    nbytes += spec.layers * n * spec.feat * esz
            tc_ms = (3.0 * flops / PEAK_TF32_FLOPS if dname == "float32"
                     else flops / PEAK_BF16_FLOPS) * 1e3
            bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
            t = times[f"{key}/{dname}"]
            e = dict(t, bound_ms=max(tc_ms, bytes_ms),
                     bound_by="operations" if tc_ms >= bytes_ms else "bytes",
                     bound_f32_fma_ms=flops / PEAK_F32_FLOPS * 1e3, flops=flops,
                     bytes=nbytes, shape=[n, spec.feat],
                     achieved_tflops=flops / (t["ms"] * 1e-3) / 1e12,
                     library_ms_blocks={
                         "row": yard[f"row_{n}x512x512/{dname}"],
                         "reduce": yard[f"reduce_512x{n}x512/{dname}"]})
            if dname == "float32":
                e["plain_ms"] = plain[key]
            if parent:
                e["parent_ms"] = theirs[f"{key}/{dname}"]
                e["turns_ms"] = [tr["times"][f"{key}/{dname}"]["ms"] for tr in turns]
            entries[f"{key}/{dname}"] = e
    # K2 and K4 at the other widths of BWD_TURN_PAIRS, beside their bounds
    for feat, fl in BWD_TURN_PAIRS:
        wspec = dataclasses.replace(fused_field_spec(load_render_config(
            PIPELINE_TOML, device=dev, trunk_impl="pallas", fc_units=feat,
            fc_use_full_features=fl == feat).field), trunk_bwd="recompute")
        for key, macs in (("heads_bwd", wspec.heads_bwd_mac_per_point()),
                          ("trunk_bwd_recompute", wspec.trunk_bwd_mac_per_point())):
            for dname in ("float32", "bfloat16"):
                k = f"{key}@{feat}x{fl}/{dname}"
                bounds = op_bounds(2.0 * macs * n, dname)
                e = {"ms": mine[k] if parent else times[k]["ms"],
                     "bound_ms": bounds["bound_3xtf32_ms" if dname == "float32"
                                        else "bound_bf16_ms"],
                     "bound_by": "operations", "shape": [n, feat, fl]}
                if parent and k in theirs:
                    e["parent_ms"] = theirs[k]
                    e["turns_ms"] = [tr["times"][k]["ms"] for tr in turns if k in tr["times"]]
                entries[k] = e
    fwd = {}
    for k in times:
        if k.startswith(("field_fused", "trunk_fwd/")):
            fwd[k] = {"ms": mine[k] if parent else times[k]["ms"]}
            if parent and k in theirs:
                fwd[k].update(parent_ms=theirs[k],
                              turns_ms=[tr["times"][k]["ms"] for tr in turns
                                        if k in tr["times"]])
    entries["forward_times"] = fwd
    extra = {"yardsticks_matmul_ms": yard,
             "bwd_bound_note": "K2/K4 bound_ms: f32 as 3xTF32 (3 x flops at 495 TFLOP/s), "
                               "bf16 at 989 TFLOP/s; bound_f32_fma_ms at 67 TFLOP/s"}
    if parent:
        extra["parent"] = {"turns": turns, "this_ms": mine, "parent_ms": theirs,
                           "k1_k3_outputs_bitwise_parent": bitwise,
                           "k1_k3_vs_parent_f32": vs_parent}
    return entries, extra


def profiled(fn, calls: int) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn`` after a synchronise ->
    (host ms of the window, [(kernel, device ms, launches)] by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernels.append((ev.key, dev_us / 1e3, ev.count))
    kernels.sort(key=lambda k: -k[1])
    return wall_ms, kernels


def profile_phase(dev, scfg, params, vocab: int) -> dict:
    """torch.profiler over two steady flagship steps: the kernels by device
    time and the device's idle share of the window."""
    import torch

    from satnerf_torch.train.state import create_train_state
    from satnerf_torch.train.step import build_train_step

    state = create_train_state(copy_params(params, dev), LR, "step", scfg.steps_per_epoch)
    step = build_train_step(scfg)
    batch = train_batch(TRAIN_RAYS, TRAIN_RAYS, 5, vocab, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = step(state, batch, gen)
    wall_ms, kernels = profiled(lambda: step(state, batch, gen), 2)
    busy = sum(k[1] for k in kernels)
    groups = {"bwd row GEMM (K2+K4)": ("row_ws_kernel", "row_kernel<", "prep_kernel"),
              "bwd reduction (K2+K4)": ("reduce_ws_kernel", "finish_kernel"),
              "K1 field_fused": ("field_fused",), "K5 composite": ("composite",)}
    by_group = {name: sum(k[1] for k in kernels if any(p in k[0] for p in pats))
                for name, pats in groups.items()}
    by_group["other kernels"] = busy - sum(by_group.values())
    line = {"phase": "train_profile", "steps": 2, "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if kernels else None,
            "by_group_ms": by_group,
            "top_kernels": [{"name": k[0][:120], "ms": k[1], "calls": k[2]}
                            for k in kernels[:15]]}
    if not kernels:
        line["note"] = "key_averages() showed no device time; the CUDA-event split stands"
    emit(line)
    return line


def trunk_forward_phase(dev, field, spec, enc) -> dict:
    """K3 against its plain version (f32, bf16; with and without the "stored"
    pre-activations; at every size of FIELD_CHECK_POINTS), each run twice for
    bitwise-equal results; K6 at every size of K6_CHECK_POINTS (``k6_check``:
    twice, bitwise K3, within the bar of the plain version)."""
    import torch

    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cases, k6 = {}, {}
    worst_f32 = 0.0
    with torch.no_grad():
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            packed = field.packed(dt)
            for n in FIELD_CHECK_POINTS:
                x = ff.pack_x(spec, enc[:n], dt)
                outs = {}
                for emit_acts in (False, True):
                    out, acts = trunk._forward(spec, x, packed, emit_acts)
                    again, acts2 = trunk._forward(spec, x, packed, emit_acts)
                    torch.cuda.synchronize()
                    ref, ref_acts = trunk.fused_trunk_reference(spec, x, packed, emit_acts)
                    check(bool(torch.isfinite(out).all()), f"trunk {dname} non-finite")
                    bitwise = torch.equal(out, again) and (
                        not emit_acts or torch.equal(acts, acts2))
                    err = float((out.float() - ref.float()).abs().max())
                    key = f"{dname}/{'acts' if emit_acts else 'no_acts'}/n{n}"
                    cases[key] = {"max_abs_err": err, "bitwise_repeat": bitwise}
                    check(bitwise, f"trunk {key}: two runs differ")
                    check(err <= TOL_FIELD[dname], f"trunk {key} err {err}")
                    if emit_acts:
                        e = rel_err(acts, ref_acts)
                        cases[key]["acts_rel_err"] = e
                        check(e <= TOL_RESID[dname], f"trunk {key} acts err {e}")
                    if dname == "float32":
                        worst_f32 = max(worst_f32, err)
                    outs[emit_acts] = out
                    del acts, acts2, ref_acts
                cases[f"{dname}/n{n}/acts_variant_bitwise"] = torch.equal(outs[True], outs[False])
            # K6 (the warp-specialised variant): bitwise K3, repeatable, within
            # the bar of the plain version
            for n in K6_CHECK_POINTS:
                x = ff.pack_x(spec, enc[:n], dt)
                k6[f"{dname}/n{n}"] = k6_check(spec, x, packed, f"{dname} n{n}")
    emit({"phase": "trunk_forward_check", "points": FIELD_CHECK_POINTS, "layers": spec.layers,
          "feat": spec.feat, "c_in": spec.c_in, "cases": cases, "k6_points": K6_CHECK_POINTS,
          "k6": k6, "tol": {"out": TOL_FIELD, "acts": TOL_RESID}})
    return {"max_abs_err_f32": worst_f32, "k6": k6}


def k6_check(spec, x, packed, key: str) -> dict:
    """K6 run twice against K3 and the plain version on the same inputs:
    both runs bitwise equal to each other and to K3, within the field bar
    of the plain version (checked); its errors."""
    import torch

    from satnerf_torch.ops import trunk

    k6 = trunk.fused_trunk_interleaved(spec, x, packed)
    k6_again = trunk.fused_trunk_interleaved(spec, x, packed)
    k3 = trunk.fused_trunk(spec, x, packed)
    torch.cuda.synchronize()
    ref = trunk.fused_trunk_reference(spec, x, packed)[0]
    dname = "float32" if x.dtype == torch.float32 else "bfloat16"
    got = {"bitwise_repeat": torch.equal(k6, k6_again), "bitwise_k3": torch.equal(k6, k3),
           "max_abs_diff_k3": float((k6.float() - k3.float()).abs().max()),
           "max_abs_err": float((k6.float() - ref.float()).abs().max()),
           "k3_max_abs_err": float((k3.float() - ref.float()).abs().max())}
    check(bool(torch.isfinite(k6).all()), f"K6 {key} non-finite")
    check(got["bitwise_repeat"], f"K6 {key}: two runs differ")
    check(got["bitwise_k3"], f"K6 {key}: not bitwise K3 ({got['max_abs_diff_k3']})")
    check(got["max_abs_err"] <= TOL_FIELD[dname], f"K6 {key} vs plain {got['max_abs_err']}")
    return got


def k6_proto_case(dev, spec, dt):
    """(spec, x, packed) at the interleave prototype's shape: 1,048,576
    points, c_in 63, with its weight scales (normal * 0.02, bias * 0.01,
    x * 0.5; tools/interleave_trunk_proto.py:89-96), seed 21, in ``dt``."""
    import dataclasses

    import torch

    sp = dataclasses.replace(spec, c_in=K6_C_IN)
    g = torch.Generator().manual_seed(21)

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    p6 = {"w0": rnd(sp.cx, sp.feat, scale=0.02),
          "w_mid": rnd(sp.layers - 1, sp.feat, sp.feat, scale=0.02),
          "w_skip": rnd(len(sp.skips), sp.cx, sp.feat, scale=0.02),
          "b": rnd(sp.layers, sp.feat, scale=0.01)}
    p6["w0"][K6_C_IN:] = 0
    p6["w_skip"][:, K6_C_IN:] = 0
    p6 = {k: (v if k == "b" else v.to(dt)).contiguous() for k, v in p6.items()}
    x6 = rnd(K6_POINTS, sp.cx, scale=0.5)
    x6[:, K6_C_IN:] = 0
    return sp, x6.to(dt).contiguous(), p6


def k6_times(dev) -> dict:
    """``--tree``: K6 at the prototype's shape (bf16) on the flagship trunk's
    widths, CUDA events; the entry point every slice of the port has."""
    import torch

    from satnerf_torch.models.field import fused_field_spec
    from satnerf_torch.ops import trunk

    spec = fused_field_spec(flagship_case(dev)["fcfg"])
    sp, x6, p6 = k6_proto_case(dev, spec, torch.bfloat16)
    with torch.no_grad():
        return {"trunk_fwd_interleaved/proto_bf16": {
            "ms": cuda_ms(lambda: trunk.fused_trunk_interleaved(sp, x6, p6), reps=3)}}


def serve_variant_phase(name: str, dev, rcfg, params: dict, vocab: int,
                        per_chunk: dict, coarse: bool = False, fields: int = 1,
                        n_cmp: int = 1024) -> dict:
    """One 128x128 request of a ``RenderService`` over ``params`` through the
    kernels (``per_chunk`` launches of each per 16,384-ray chunk, no plain
    version, the K1/K3 weights of each of its ``fields`` prepared once), its
    first ``n_cmp`` rays held against the plain path on CPU copies of the
    weights within TOL_SERVE_CPU (TOL_SERVE_CPU_BF16 in bf16); with
    ``coarse``, the hierarchical ``<k>_coarse`` outputs of those rays on the
    card against the CPU's too."""
    import numpy as np
    import torch

    from satnerf_torch.ops import trunk
    from satnerf_torch.render.renderer import render_image_chunked
    from satnerf_torch.serve.service import RenderService

    svc = RenderService(params, rcfg, chunk=CHUNK, device=dev)
    tol = TOL_SERVE_CPU_BF16 if rcfg.compute_dtype == "bfloat16" else TOL_SERVE_CPU
    n_rays = SERVE_H * SERVE_W
    rays, extras = synthetic_rays(n_rays, 300, vocab)
    reset_counters()
    before = trunk.TC_PREPARATIONS
    t0 = time.monotonic()
    out = svc.render_rays(rays, extras, SERVE_H, SERVE_W)
    req_ms = (time.monotonic() - t0) * 1e3
    preps = trunk.TC_PREPARATIONS - before
    got, plain_calls = read_counters()
    check(preps == fields, f"{name}: {preps} K1/K3 weight preparations, expected {fields}")
    chunks = -(-n_rays // CHUNK)
    want = {k: v * chunks for k, v in per_chunk.items()}
    check({k: got[k] for k in want} == want, f"{name} launches {got}, expected {want}")
    check(not any(plain_calls.values()), f"{name}: a plain version ran: {plain_calls}")
    for k, v in out.items():
        if v.dtype.kind == "f":
            check(bool(np.isfinite(v).all()), f"{name} {k} non-finite")
    check(out["rgb"].shape == (SERVE_H, SERVE_W, 3), f"{name} rgb shape")

    cpu = copy_params(svc.params, "cpu")
    ref = render_image_chunked(cpu, svc.rcfg, rays[:n_cmp], extras[:n_cmp], chunk=n_cmp,
                               device="cpu")
    err = {"rgb": float(np.abs(out["rgb"].reshape(-1, 3)[:n_cmp] - ref["rgb"]).max()),
           "depth": float(np.abs(out["depth"].reshape(-1)[:n_cmp] - ref["depth"]).max())}
    agree = float(np.mean(out["semantic_label"].reshape(-1)[:n_cmp] == ref["semantic_label"]))
    line = {"phase": name, "rays": n_rays, "chunk": CHUNK, "request_ms": req_ms,
            "rays_per_s": n_rays / (req_ms / 1e3), "launches": got, "preparations": preps,
            "cpu_plain_max_abs_err": err, "cpu_label_agreement": agree,
            "cpu_rays": n_cmp, "tol": tol}
    for k, bar in tol.items():
        check(err[k] <= bar, f"{name} vs CPU {k} err {err[k]}")
    check(agree >= 0.99, f"{name}: semantic labels agree on {agree}")
    if coarse:
        on_card = render_image_chunked(svc.params, svc.rcfg, rays[:n_cmp], extras[:n_cmp],
                                       chunk=n_cmp, device=dev)
        keys = ("rgb_coarse", "depth_coarse", "semantic_logits_coarse",
                "semantic_label_coarse")
        check(all(k in on_card for k in keys) and "coarse" not in on_card,
              f"{name}: coarse keys {sorted(on_card)}")
        c_err = {k: float(np.abs(on_card[k] - ref[k]).max()) for k in keys[:2]}
        line["coarse_keys"] = list(keys)
        line["coarse_cpu_max_abs_err"] = c_err
        for k, e in c_err.items():
            check(e <= TOL_SERVE_CPU[k.split("_")[0]], f"{name} {k} vs CPU {e}")
    emit(line)
    return {"launches": got, "request_ms": req_ms}


def trunk_times_phase(dev, field, spec, enc_fn, turns: list | None = None) -> dict:
    """K3 and K6 in turns (K3, K6, K6, K3; ``cuda_ms`` and ``device_time``)
    beside their bounds and the plain version's time at K6_TIME_SHAPES: f32
    at K3's depth and main renders (65,536, 131,072) and a serve chunk's
    1,048,576 points (c_in 60), bf16 at the interleave prototype's shape
    (1,048,576 x 63); K6 at that shape checked in both dtypes
    (``k6_check``). With ``turns`` (``--parent``), the parent's K6 beside
    this one at the prototype's shape, in the same turns."""
    import dataclasses

    import torch

    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    def macs(sp):  # trunk multiply-adds per point (FieldSpec's counting)
        return sp.c_in * sp.feat + (sp.layers - 1) * sp.feat ** 2 \
            + len(sp.skips) * sp.c_in * sp.feat

    def entry(ms, plain_ms, sp, n, x, packed):
        flops = 2.0 * macs(sp) * n
        nbytes = (x.numel() + n * sp.feat) * x.element_size() + sum(
            t.numel() * t.element_size() for t in packed.values())
        bounds = op_bounds(flops, "float32" if x.dtype == torch.float32 else "bfloat16")
        ops_ms, bytes_ms = bounds.pop("ops_ms"), nbytes / PEAK_HBM_BYTES * 1e3
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **bounds,
                "flops": flops, "bytes": nbytes, "shape": [n, sp.cx],
                "achieved_tflops": flops / (ms * 1e-3) / 1e12}

    out, in_turns = {}, {}
    with torch.no_grad():
        for dname, n, case in K6_TIME_SHAPES:
            dt = torch.float32 if dname == "float32" else torch.bfloat16
            if case == "proto":
                sp, x, packed = k6_proto_case(dev, spec, dt)
                for d2 in (torch.float32, torch.bfloat16):  # K6 at this shape, both dtypes
                    sp2, x2, p2 = (sp, x, packed) if d2 == dt else k6_proto_case(dev, spec, d2)
                    out[f"k6_check_{d2}".replace("torch.", "")] = k6_check(sp2, x2, p2,
                                                                           f"{d2} proto")
                    del x2, p2
            else:
                sp, packed = spec, field.packed(dt)
                x = ff.pack_x(spec, enc_fn(n), dt)
            k3_ms, k6_ms, k3_dev, k6_dev = [], [], [], []
            for fn in (trunk.fused_trunk, trunk.fused_trunk_interleaved,
                       trunk.fused_trunk_interleaved, trunk.fused_trunk):
                call = lambda: fn(sp, x, packed)  # noqa: E731
                ms, dev_t = cuda_ms(call, reps=5), device_time(call, reps=5, warmup=1)
                (k3_ms if fn is trunk.fused_trunk else k6_ms).append(ms)
                (k3_dev if fn is trunk.fused_trunk else k6_dev).append(dev_t["ms"])
            plain = cuda_ms(lambda: trunk.fused_trunk_reference(sp, x, packed), reps=1)
            err = float((trunk.fused_trunk(sp, x, packed).float()
                         - trunk.fused_trunk_reference(sp, x, packed)[0].float()).abs().max())
            check(err <= TOL_FIELD[dname], f"K3 {dname} at {n} points err {err}")
            key = f"{dname}_{n}" + ("_c63" if case == "proto" else "")
            for name, ms_l, dev_l in (("k3", k3_ms, k3_dev), ("k6", k6_ms, k6_dev)):
                out[f"{name}_{key}"] = {**entry(sum(ms_l) / 2, plain, sp, n, x, packed),
                                        "device_ms": sum(dev_l) / 2}
            out[f"k3_{key}"]["max_abs_err"] = err
            in_turns[key] = {"cuda_ms": {"k3": k3_ms, "k6": k6_ms},
                             "device_ms": {"k3": k3_dev, "k6": k6_dev},
                             "k6_over_k3": sum(k6_ms) / sum(k3_ms),
                             "k6_over_k3_device": sum(k6_dev) / sum(k3_dev)}
            del x
    out["turns"] = in_turns
    if turns:
        mine, theirs = turn_means(turns)
        k = "trunk_fwd_interleaved/proto_bf16"
        out["k6_parent_turns"] = {"ms": [t["times"][k]["ms"] for t in turns],
                                  "trees": [t["tree"] for t in turns],
                                  "this_ms": mine[k], "parent_ms": theirs[k]}
    emit({"phase": "trunk_kernel_times", "mac_per_point_c_in_60": macs(spec),
          "mac_per_point_c_in_63": macs(dataclasses.replace(spec, c_in=K6_C_IN)),
          "times": out})
    return out


def step_times(dev, steps: int = 5) -> dict:
    """ms per training step of the flagship and Path B configurations (seeded
    as train_phase; CUDA events over ``steps`` steps after two warm-up
    steps). Only entry points every slice has, for the turns."""
    import dataclasses

    import torch

    from satnerf_torch.configs import load_pipeline_toml, step_config_from_pipeline
    from satnerf_torch.train.state import create_train_state, init_params
    from satnerf_torch.train.step import build_train_step

    out = {}
    for name, overrides in (("flagship", {}), ("path_b", HIER)):
        p = load_pipeline_toml(PIPELINE_TOML)
        p.update(trunk_impl="pallas", **overrides)
        scfg = step_config_from_pipeline(p, steps_per_epoch=1000, n_classes=5, car_index=4,
                                         device=dev)
        scfg = dataclasses.replace(scfg, use_car_reg_loss=True, car_reg_loss_start=0,
                                   first_beta_epoch=0)
        params = init_params(torch.Generator().manual_seed(0), scfg.render.field, t_vocab=50,
                             device=dev, use_fine_network=scfg.render.use_fine_network)
        state = create_train_state(params, LR, "step", scfg.steps_per_epoch)
        step = build_train_step(scfg)
        batch = train_batch(TRAIN_RAYS, TRAIN_RAYS, 5, 50, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        for _ in range(2):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(steps):
            state, _ = step(state, batch, gen)
        t1.record()
        torch.cuda.synchronize()
        out[f"step/{name}"] = {"ms": t0.elapsed_time(t1) / steps}
        del state, params, step, batch
    return out


def bench_step_times(dev) -> dict:
    """ms per replayed step of the JAX bench's configuration
    (``satnerf_torch.bench.main`` at its defaults, BENCH_MAIN_STEPS steps a
    window, over all its windows) and its rays/s, for the turns; an entry
    point every slice with the bench's windowed ``main(steps)`` has."""
    from satnerf_torch import bench

    with tool_env({}):
        line = bench.main(BENCH_MAIN_STEPS)
    return {"step/bench": {"ms": line["ms_per_step_all_windows"],
                           "rays_per_sec": line["rays_per_sec_all_windows"]}}


def forward_builds(build) -> dict:
    """{library: {kernel: ptxas's registers and spills, and its SASS
    instruction count}} of K1's and K3's libraries as the ``_build`` module
    given (this tree's, or an older checkout's in child_times) built them."""
    out = {}
    for lib in ("field_fused", "trunk_fwd"):
        rows = build.ptxas_report(lib)
        sass = build.sass_counts(lib, " ;")  # cuobjdump -sass ends each instruction so
        for k, row in rows.items():
            row["sass_instructions"] = sass.get(k) if isinstance(sass, dict) else sass
        out[lib] = rows
    return out


def child_times(tree: str, save: str) -> int:
    """``--tree DIR --save FILE``: port_times, composite_times, step_times,
    bench_step_times and k6_times on the checkout at DIR (its own package and kernels),
    printing its build (seconds, forward_builds) and the times as the last
    line."""
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        return 2
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.ops import _build

    disable_tf32()
    t0 = time.monotonic()
    per = _build.build_all()
    print(json.dumps({"child_build": {"seconds": time.monotonic() - t0,
                                      "per_source_seconds": per,
                                      "forward_kernels": forward_builds(_build)}}), flush=True)
    dev = torch.device("cuda")
    print(json.dumps({**port_times(dev, save), **composite_times(dev), **step_times(dev),
                      **bench_step_times(dev), **k6_times(dev)}), flush=True)
    return 0


def scene_expected_launches(trainer, steps: int, ds_drop: int) -> dict:
    """Launches of a train_scene run: per step K1/K2/K4 3 and K5/K5-bwd 2
    until the depth drop, 2 and 1 after it; per validation chunk one K1 and
    one K5."""
    from satnerf_torch.train.loop import val_chunk_rays

    rgb_test = trainer.pipeline.datasets["rgb_test"]
    chunk = val_chunk_rays(trainer.cfg.pipeline)
    per_image = [-(-len(item["rays"]) // chunk) for item in rgb_test.data]
    chunks = sum(sum(per_image[:1] if v["sanity"] else per_image) for v in trainer.val_history)
    d, nd = min(ds_drop, steps), steps - min(ds_drop, steps)
    return {"field_fused": 3 * d + 2 * nd + chunks, "heads_bwd": 3 * d + 2 * nd,
            "trunk_fwd": 0, "trunk_bwd": 3 * d + 2 * nd,
            "composite": 2 * d + nd + chunks, "composite_bwd": 2 * d + nd,
            "trunk_fwd_interleaved": 0}


def train_scene_phase(dev, work: str) -> dict:
    """The port's training CLI end to end on the card: a generated scene
    under ``work``, ``start_training`` on the flagship TOML as it is (run
    A), the same run stopped at SCENE_STOP by ``request_stop`` from a step
    callback and continued by the resume entry point (run B, bitwise equal
    to A), and A's best checkpoint served by
    ``RenderService.from_checkpoint``. Returns the phase's line with run A's
    directory (``run_dp``) and trainer (``trainer``) beside it, for the
    eval_scene and serve_view phases."""
    import glob

    import numpy as np
    import torch

    from satnerf_torch.configs import load_configs, write_toml
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.ops import native, trunk
    from satnerf_torch.run.resume_training import prepare_resume
    from satnerf_torch.run.training import prepare_trainer, start_training
    from satnerf_torch.serve.service import RenderService
    from satnerf_torch.train.checkpoint import export_params
    from satnerf_torch.train.loop import val_chunk_rays

    t_phase = time.monotonic()
    try:
        t0 = time.monotonic()
        generate_scene(os.path.join(work, "datasets", "SYN"), **SCENE)
        scene_s = time.monotonic() - t0
        run_fp = os.path.join(work, "run.toml")
        write_toml(run_fp, {
            "max_train_steps": SCENE_STEPS, "save_every_n_epochs": 1,
            "check_val_every_n_epoch": 1, "num_sanity_val_steps": 1, "seed": 0,
            "dataset_name": "SYN", "datasets_dp": os.path.join(work, "datasets"),
            "cache_dp": os.path.join(work, "cache"),
            "workspace_dp": os.path.join(work, "training")})

        # ---- run A: start_training, uninterrupted ----
        reset_counters()
        preps0 = trunk.TC_PREPARATIONS
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        pipeline, state_a, trainer_a = start_training(run_fp, SCENE_PIPELINE, device=dev,
                                                      log_every=1)
        run_a_s = time.monotonic() - t0
        got, plain_calls = read_counters()
        preps = trunk.TC_PREPARATIONS - preps0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        run_dp = pipeline.cfg.run.run_dp
        ds_drop = pipeline.ds_drop_step
        spe = len(pipeline.datasets["rgb"]) // pipeline.cfg.pipeline.batch_size
        check(state_a.step == SCENE_STEPS, f"run A ended at step {state_a.step}")
        check(ds_drop == SCENE_STEPS // 4 and spe == SCENE_STEPS // 4,
              f"depth drop {ds_drop}, steps per epoch {spe}")
        want = scene_expected_launches(trainer_a, SCENE_STEPS, ds_drop)
        check(got == want, f"train_scene launches {got}, expected {want}")
        check(not any(plain_calls.values()), f"train_scene: a plain version ran: {plain_calls}")
        n_val = len(trainer_a.val_history)
        check(preps == SCENE_STEPS + n_val,
              f"K1 weight preparations {preps}: expected one per step and per "
              f"validation ({SCENE_STEPS} + {n_val})")
        hist = trainer_a.history
        check(len(hist) == SCENE_STEPS, f"{len(hist)} logged steps")
        bad = [h["step"] for h in hist if not all(math.isfinite(v) for v in h.values())]
        check(not bad, f"non-finite loss terms at steps {bad[:5]}")
        # the beta gate changes the rgb loss from the plain MSE to the
        # uncertainty-weighted one, larger at the same fit, so the total loss
        # of the first 12 steps and the last 12 measure two objectives; the
        # loss is held on the plain rgb MSE of the batch (10^(-psnr/10)),
        # which means the same on both sides of the gate, and on the train PSNR
        beta_on = 2 * spe
        mse_first, mse_last = _rgb_mse_falls(hist, 12)
        psnr_first = sum(h["psnr"] for h in hist[:12]) / 12
        psnr_last = sum(h["psnr"] for h in hist[-12:]) / 12
        check(psnr_last > psnr_first, f"train PSNR did not rise: {psnr_first} -> {psnr_last}")
        check(hist[ds_drop - 1].get("depth_loss_activated") == 1.0
              and "depth_loss_activated" not in hist[ds_drop], "depth drop switch")
        check(hist[beta_on - 1]["beta_loss_activated"] == 0.0
              and hist[beta_on]["beta_loss_activated"] == 1.0, "beta gate at epoch 2")
        for rel in ("configs/run.toml", "configs/pipeline.toml", "ckpoints/last.ckpt",
                    "ckpoints/best.ckpt"):
            check(os.path.isfile(os.path.join(run_dp, rel)), f"missing {rel}")
        epochs = sorted(glob.glob(os.path.join(run_dp, "ckpoints", "epoch_*.ckpt")))
        check(len(epochs) == SCENE_STEPS // spe, f"epoch checkpoints {epochs}")
        dsms = glob.glob(os.path.join(run_dp, "visualization", "train", "dsm", "*.tif"))
        check(len(dsms) > 0, "no DSM under visualization/train/dsm")
        val = trainer_a.val_history[-1]
        val_keys = ["train/psnr", "train/mae"] + [k for k in val if k.startswith("train/ssim_")]
        check(all(k in val and math.isfinite(val[k]) for k in val_keys),
              f"last validation {val}")
        check(all(val[k] <= 1.0 for k in val if "/ssim_" in k), f"SSIM above 1: {val}")
        check(native.get_lib() is not None, "the native host library did not load")
        # the visualizers of every validation but the sanity one: each TIF of
        # each image (run_all swallows a failing visualizer, so count them)
        rgb_test = pipeline.datasets["rgb_test"]
        tif_viz = [v for v in pipeline.visualizers() if v.save_as_tif]
        viz_epochs = [v["epoch"] for v in trainer_a.val_history if not v["sanity"]]
        missing = [v.tif_path(run_dp, item["split"], item["name"], e)
                   for e in viz_epochs for item in map(rgb_test.image_item,
                                                       range(len(rgb_test.data)))
                   for v in tif_viz
                   if not os.path.isfile(v.tif_path(run_dp, item["split"], item["name"], e))]
        check(len(tif_viz) == 11 and not missing, f"visualizer TIFs missing: {missing[:5]}")

        # ---- run B: stopped by request_stop at SCENE_STOP, then resumed ----
        cfgs = load_configs(run_fp, SCENE_PIPELINE)
        cfgs.create_run_dp()
        trainer_b = prepare_trainer(cfgs, dev, log_every=1)
        state_b = trainer_b.fit(step_callbacks={
            SCENE_STOP: lambda state, step: trainer_b.request_stop()})
        check(state_b.step == SCENE_STOP, f"run B stopped at {state_b.step}")
        trainer_c = prepare_resume(cfgs.run.run_dp, dev, log_every=1)
        state_c = trainer_c.fit()
        check(state_c.step == SCENE_STEPS, f"run B resumed to {state_c.step}")
        pa, pc = export_params(state_a.params), export_params(state_c.params)
        check(set(pa) == set(pc), "run A and B params differ in keys")
        resume_diff = max(float((pa[k] - pc[k]).abs().max()) for k in pa)
        resume_bitwise = all(torch.equal(pa[k], pc[k]) for k in pa)
        check(resume_diff <= 1e-6, f"resumed run differs from run A by {resume_diff}")
        resume_losses_equal = ([h["loss"] for h in hist[SCENE_STOP:]]
                               == [h["loss"] for h in trainer_c.history])

        # ---- serve A's best and hold it to that validation's render ----
        rgb_test = pipeline.datasets["rgb_test"]
        item = rgb_test.image_item(len(rgb_test.data) - 1)
        svc = RenderService.from_checkpoint(
            os.path.join(run_dp, "ckpoints", "best.ckpt"), SCENE_PIPELINE,
            n_classes=pipeline.n_classes, chunk=val_chunk_rays(pipeline.cfg.pipeline),
            device=dev)
        t0 = time.monotonic()
        served = svc.render_rays(item["rays"], item["extras"], item["h"], item["w"])
        serve_ms = (time.monotonic() - t0) * 1e3
        ref = trainer_a.best_val_renders[item["name"]]
        serve_err = {
            "rgb": float(np.abs(served["rgb"].reshape(-1, 3)
                                - np.clip(ref["rgb"], 0, 1)).max()),
            "depth": float(np.abs(served["depth"].reshape(-1) - ref["depth"]).max()),
        }
        for k, e in serve_err.items():
            check(e <= TOL_SCENE_SERVE, f"served best vs validation render {k} err {e}")
        prof_a = trainer_a.profiler
        saves = trainer_a.ckpt.seconds["save"]

        def mean_s(prof, name):
            return prof.totals[name] / prof.counts[name]

        line = {
            "phase": "train_scene", "scene": SCENE, "steps": SCENE_STEPS,
            "steps_per_epoch": spe, "depth_drop_step": ds_drop, "beta_gate_step": beta_on,
            "depth_batch": trainer_a.pipeline.datasets["depth"].combined["rays"].shape[0],
            "launches": got, "expected_launches": want, "plain_calls": plain_calls,
            "preparations": preps, "validations": n_val,
            "rgb_mse_first12_mean": mse_first, "rgb_mse_last12_mean": mse_last,
            "loss_first12_mean": sum(h["loss"] for h in hist[:12]) / 12,
            "loss_last12_mean": sum(h["loss"] for h in hist[-12:]) / 12,
            "psnr_first12_mean": psnr_first, "psnr_last12_mean": psnr_last,
            "last_validation": val, "native_lib": True,
            "loop_ms_per_step_host": trainer_a.ms_per_step,
            "validate_s": mean_s(prof_a, "validate"), "dsm_mae_s": mean_s(prof_a, "dsm_mae"),
            "visualize_s_per_validation": prof_a.totals["visualize"] / len(viz_epochs),
            "visualize_s_per_image": mean_s(prof_a, "visualize"),
            "visualizer_tifs": len(tif_viz) * len(viz_epochs) * len(rgb_test.data),
            "checkpoint_save_s": sum(saves) / len(saves), "checkpoint_saves": len(saves),
            "checkpoint_restore_s": trainer_c.ckpt.seconds["restore"],
            "peak_memory_gb": peak_gb, "scene_s": scene_s, "run_a_s": run_a_s,
            "resume_max_abs_diff": resume_diff, "resume_bitwise": resume_bitwise,
            "resume_losses_equal": resume_losses_equal,
            "serve_ms": serve_ms, "serve_vs_validation_max_abs_err": serve_err,
            "tol": {"resume": 1e-6, "serve": TOL_SCENE_SERVE},
            "seconds": time.monotonic() - t_phase,
        }
        emit(line)
        return {**line, "run_dp": run_dp, "trainer": trainer_a}
    finally:
        disable_tf32()  # the run's matmul_precision "high" allowed TF32


def _tensors_equal(a: dict, b: dict) -> bool:
    """Two dicts of tensors (nested in dicts) hold the same keys and bits."""
    import torch

    if set(a) != set(b):
        return False
    return all(_tensors_equal(a[k], b[k]) if isinstance(a[k], dict)
               else torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)


def _dispatch_fit(dev, work: str, name: str, pipe_fp: str, k: int) -> dict:
    """One Trainer.fit of DISPATCH_STEPS steps on the dispatch scene with
    steps_per_dispatch ``k`` (no validation) -> its counts and state."""
    import torch

    from satnerf_torch.configs import load_configs, write_toml
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.ops import trunk
    from satnerf_torch.run.training import prepare_trainer
    from satnerf_torch.train.checkpoint import export_params

    run_fp = os.path.join(work, f"{name}_k{k}.toml")
    write_toml(run_fp, {
        "max_train_steps": DISPATCH_STEPS, "num_sanity_val_steps": 0, "seed": 0,
        "steps_per_dispatch": k, "dataset_name": "DISPATCH",
        "datasets_dp": os.path.join(work, "datasets"), "cache_dp": os.path.join(work, "cache"),
        "workspace_dp": os.path.join(work, f"training_{name}_k{k}")})
    cfgs = load_configs(run_fp, pipe_fp)
    cfgs.create_run_dp()
    try:
        trainer = prepare_trainer(cfgs, dev)
        reset_counters()
        preps0 = trunk.TC_PREPARATIONS
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        state = trainer.fit(validate_every_epoch=False)
        seconds = time.monotonic() - t0
        launches, plain = read_counters()
        preps = trunk.TC_PREPARATIONS - preps0
    finally:
        disable_tf32()  # the run's matmul_precision "high" allowed TF32
    opt = state.optimizer
    return {"launches": launches, "plain": plain, "preparations": preps,
            "params": export_params(state.params),
            "adam": {"exp_avg": [t.cpu() for t in opt.exp_avg],
                     "exp_avg_sq": [t.cpu() for t in opt.exp_avg_sq],
                     "count": opt.count.cpu()},
            "last": trainer.history[-1], "step": state.step,
            "drop": trainer.pipeline.ds_drop_step,
            "spe": len(trainer.pipeline.datasets["rgb"]) // trainer.cfg.pipeline.batch_size,
            "graphs": trainer.dispatch.graph_stats(),
            "captured": {("depth" if d else "no_depth"): captured_launches(v.graph)
                         for d, v in trainer.dispatch.variants.items() if v.graph is not None},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "seconds": seconds}


def dispatch_times(dev, scfg, params: dict, batch: dict, turn_steps: int) -> dict:
    """ms a step at K = 1 (eager steps) and K = DISPATCH_K (dispatches of
    that many replays) in turns (1, K, K, 1) of ``turn_steps`` steps, CUDA
    events around each turn, from one state; the capture's seconds, the
    peak memory of the eager steps (before the capture) and of the replays
    (the capture on); torch.profiler over two steps at each K (the device's
    idle share)."""
    import torch

    from satnerf_torch.train.dispatch import StepGraph
    from satnerf_torch.train.state import create_train_state
    from satnerf_torch.train.step import build_train_step

    state = create_train_state(copy_params(params, dev), LR, "step", scfg.steps_per_epoch)
    step = build_train_step(scfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    graph = StepGraph(state, lambda: step.update(state, batch, gen), gen)

    def eager():
        return step(state, batch, gen)[1]["loss"]

    def replay():
        return graph.step()["loss"]

    def turn(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(turn_steps):
            loss = fn()
        end.record()
        torch.cuda.synchronize()
        check(math.isfinite(float(loss)), f"dispatch turn: loss {float(loss)}")
        return start.elapsed_time(end) / turn_steps

    eager()  # the warm-up step: what the step builds on first use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = {1: [turn(eager)], DISPATCH_K: []}
    peak_k1 = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    graph.capture()
    ms[DISPATCH_K].append(turn(replay))
    peak_k8 = torch.cuda.max_memory_allocated() / 1e9
    ms[DISPATCH_K].append(turn(replay))
    ms[1].append(turn(eager))
    idle = {}
    for k, fn in ((1, eager), (DISPATCH_K, replay)):
        wall_ms, kernels = profiled(fn, 2)
        busy = sum(x[1] for x in kernels)
        idle[k] = ({"wall_ms": wall_ms, "device_busy_ms": busy, "kernels": len(kernels),
                    "launches": sum(x[2] for x in kernels), "idle_share": 1.0 - busy / wall_ms}
                   if kernels else {"wall_ms": wall_ms, "note": "key_averages() showed no "
                                    "device time: no idle share"})
    return {"turn_steps": turn_steps, "turns_ms": {f"k{k}": v for k, v in ms.items()},
            "ms_per_step": {f"k{k}": sum(v) / len(v) for k, v in ms.items()},
            "capture_s": graph.capture_seconds, "peak_gb": {"k1": peak_k1, f"k{DISPATCH_K}": peak_k8},
            "profile_two_steps": {f"k{k}": v for k, v in idle.items()},
            "launches_per_replayed_step": captured_launches(graph)}


def train_dispatch_phase(dev, work: str, trained: dict, vocab: int) -> dict:
    """steps_per_dispatch on the card: for each of DISPATCH_PATHS, K = 1 and
    K = DISPATCH_K from the same seed across the depth drop, epoch ends and
    the beta gate, bitwise equal (parameters, Adam's moments and count, the
    last metrics), the same launches and K1/K3 weight preparations, and a
    replayed depth step's launches those of the path's step; the training
    CLI on train_scene's scene for one epoch with its validation at both K,
    ``last.ckpt`` bitwise equal; then ms a step at K = 1 and K = DISPATCH_K
    in turns (``dispatch_times``) at the step configs of ``trained``
    (``{"flagship": train_phase's result, "path_b": train_hier's}``, at
    1,024 + 1,024 rays) and at the bench's configuration."""
    import torch

    from satnerf_torch import bench
    from satnerf_torch.configs import load_pipeline_toml, write_toml
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.run.training import start_training
    from satnerf_torch.train.state import init_params

    t_phase = time.monotonic()
    line = {"phase": "train_dispatch", "k": DISPATCH_K, "scene": DISPATCH_SCENE,
            "steps": DISPATCH_STEPS,
            "counting": "a replayed step counts the launches captured for its one step "
                        "(count_replays)", "paths": {}}
    generate_scene(os.path.join(work, "datasets", "DISPATCH"), **DISPATCH_SCENE)
    base = load_pipeline_toml(PIPELINE_TOML)
    for name, overrides, per_step in DISPATCH_PATHS:
        pipe_fp = os.path.join(work, f"dispatch_{name}.toml")
        write_toml(pipe_fp, {**base, **overrides})
        one = _dispatch_fit(dev, work, name, pipe_fp, 1)
        many = _dispatch_fit(dev, work, name, pipe_fp, DISPATCH_K)
        check(one["step"] == many["step"] == DISPATCH_STEPS and (one["drop"], one["spe"]) == (8, 9),
              f"dispatch {name}: steps {one['step']} {many['step']}, drop {one['drop']}, "
              f"epoch {one['spe']}")
        bitwise = {"params": _tensors_equal(one["params"], many["params"]),
                   "adam": all(torch.equal(a, b) for key in ("exp_avg", "exp_avg_sq")
                               for a, b in zip(one["adam"][key], many["adam"][key]))
                   and torch.equal(one["adam"]["count"], many["adam"]["count"]),
                   "last_metrics": one["last"] == many["last"]}
        check(all(bitwise.values()), f"dispatch {name}: K = {DISPATCH_K} differs from K = 1: "
                                     f"{bitwise}")
        check(many["launches"] == one["launches"] and many["preparations"] == one["preparations"],
              f"dispatch {name}: launches {many['launches']} ({many['preparations']} "
              f"preparations), eager {one['launches']} ({one['preparations']})")
        check(not any(one["plain"].values()) and not any(many["plain"].values()),
              f"dispatch {name}: a plain version ran: {one['plain']} {many['plain']}")
        graphs = many["graphs"]
        check(graphs["depth"]["replays"] == DISPATCH_K - 1 and graphs["no_depth"]["replays"]
              == DISPATCH_STEPS - DISPATCH_K - 1, f"dispatch {name}: replays {graphs}")
        depth_step = {k: v for k, v in many["captured"]["depth"].items() if k != "preparations"}
        check(depth_step == per_step, f"dispatch {name}: a replayed depth step launches "
                                      f"{depth_step}, expected {per_step}")
        line["paths"][name] = {
            "overrides": overrides, "bitwise": bitwise, "launches": many["launches"],
            "preparations": many["preparations"], "graphs": graphs,
            "launches_per_replayed_step": many["captured"],
            "peak_gb": {"k1": one["peak_gb"], f"k{DISPATCH_K}": many["peak_gb"]},
            "fit_seconds": {"k1": one["seconds"], f"k{DISPATCH_K}": many["seconds"]}}
        del one, many

    # the training CLI on train_scene's scene: one epoch and its validation
    cli = {}
    try:
        for k in (1, DISPATCH_K):
            run_fp = _scene_run_toml(work, f"dispatch_cli_k{k}.toml", steps_per_dispatch=k)
            reset_counters()
            t0 = time.monotonic()
            pipeline, state, trainer = start_training(run_fp, SCENE_PIPELINE, device=dev)
            launches, plain = read_counters()
            raw = torch.load(os.path.join(pipeline.cfg.run.run_dp, "ckpoints", "last.ckpt"),
                             map_location="cpu", weights_only=True)
            cli[k] = {"raw": raw, "launches": launches, "plain": plain,
                      "val": trainer.val_history, "seconds": time.monotonic() - t0,
                      "graphs": trainer.dispatch.graph_stats()}
            del pipeline, state, trainer
    finally:
        disable_tf32()
    a, b = cli[1], cli[DISPATCH_K]
    ckpt_bitwise = (a["raw"]["step"] == b["raw"]["step"] == DP_STEPS
                    and _tensors_equal(a["raw"]["state_dict"], b["raw"]["state_dict"])
                    and _tensors_equal(a["raw"]["optimizer"]["state"],
                                       b["raw"]["optimizer"]["state"])
                    and torch.equal(a["raw"]["optimizer"]["count"], b["raw"]["optimizer"]["count"])
                    and a["raw"]["best_mae"] == b["raw"]["best_mae"])
    check(ckpt_bitwise and a["val"] == b["val"] and len(a["val"]) == 1,
          f"dispatch CLI: last.ckpt or the validation differs (bitwise {ckpt_bitwise}): "
          f"{a['val']} {b['val']}")
    check(a["launches"] == b["launches"] and not any(b["plain"].values()),
          f"dispatch CLI launches {b['launches']}, eager {a['launches']}")
    check(b["graphs"]["no_depth"]["replays"] > 0, f"dispatch CLI graphs {b['graphs']}")
    line["cli"] = {"steps": DP_STEPS, "last_ckpt_bitwise": ckpt_bitwise,
                   "validation": b["val"], "launches": b["launches"], "graphs": b["graphs"],
                   "seconds": {"k1": a["seconds"], f"k{DISPATCH_K}": b["seconds"]}}
    del cli, a, b

    # ms a step in turns: the flagship step config, the bench's and Path B's
    batch = train_batch(TRAIN_RAYS, TRAIN_RAYS, 5, vocab, dev)
    fcfg, _, scfg = bench.configs(bench.settings({}), dev)
    cases = {"flagship": (trained["flagship"]["scfg"], trained["flagship"]["params"], batch,
                          PER_STEP),
             "bench": (scfg, init_params(torch.Generator().manual_seed(0), fcfg, t_vocab=50,
                                         device=dev),
                       bench.synthetic_batch(8192, depth=bench.DEPTH_RAYS, device=dev), PER_STEP),
             "path_b": (trained["path_b"]["scfg"], trained["path_b"]["params"], batch,
                        PER_STEP_HIER)}
    line["times"] = {}
    for name, (scfg, params, batch, per_step) in cases.items():
        t = line["times"][name] = dispatch_times(dev, scfg, params, batch,
                                                 DISPATCH_TURN_STEPS)
        per = {k: v for k, v in t["launches_per_replayed_step"].items() if k != "preparations"}
        check(per == per_step, f"dispatch times {name}: a replayed step launches {per}")
    torch.cuda.empty_cache()  # the pools of this phase's graphs, for later phases
    line["seconds"] = time.monotonic() - t_phase
    emit(line)
    return line


def _results_values(node, path=""):
    """(path, leaf) of every value of a results.json tree."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _results_values(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _results_values(v, f"{path}[{i}]")
    else:
        yield path, node


def _check_results(key: str, tree) -> None:
    """A results.json tree: every value finite, null only under
    per_class_iou, SSIM at most 1, accuracy, mIoU and IoU in [0, 1]."""
    for path, v in _results_values(tree):
        if v is None:
            check("/per_class_iou/" in path, f"{key}{path} is null")
            continue
        x = float(v)
        check(math.isfinite(x), f"{key}{path} = {v}")
        low = path.lower()
        if "ssim" in low:
            check(x <= 1.0, f"{key}{path} SSIM {v} above 1")
        if "accuracy" in low or "miou" in low or "per_class_iou" in low:
            check(0.0 <= x <= 1.0, f"{key}{path} = {v} outside [0, 1]")


def _check_chunk_launches(phase: str, got: dict, plain_calls: dict, chunks: int) -> dict:
    """The launches of images rendered in chunks (eval, visualizers): K1
    and K5 once per chunk, nothing else, no plain version. Returns what was
    expected."""
    want = {k: 0 for k in got}
    want["field_fused"] = want["composite"] = chunks
    check(got == want, f"{phase} launches {got}, expected {want}")
    check(not any(plain_calls.values()), f"{phase}: a plain version ran: {plain_calls}")
    return want


def _rgb_mse_falls(hist: list, n: int) -> tuple:
    """The batch's plain rgb MSE (10^(-psnr/10)) over a run's first and last
    ``n`` steps, which fails the phase unless it fell."""
    mse_first = sum(10.0 ** (-h["psnr"] / 10.0) for h in hist[:n]) / n
    mse_last = sum(10.0 ** (-h["psnr"] / 10.0) for h in hist[-n:]) / n
    check(mse_last < mse_first, f"rgb MSE did not fall: first {n} steps {mse_first}, "
                                f"last {n} {mse_last}")
    return mse_first, mse_last


def eval_scene_phase(dev, scene: dict, work: str) -> dict:
    """The eval battery on train_scene's run A: ``eval_all`` inline over the
    train and test splits (K1 and K5 once per chunk of every image, one K1
    weight preparation, no plain call), its results.json values finite and
    in range, the test split's PSNR and MAE those of the validation that
    saved ``best``, one PLY point per ray, and the test split again through
    fresh worker processes (``isolate="subprocess"``, one image each) with
    the same results.json, string for string."""
    import numpy as np

    from satnerf_torch.device import disable_tf32
    from satnerf_torch.eval.eval import eval_all
    from satnerf_torch.eval.extract_pointcloud import read_ply
    from satnerf_torch.ops import trunk

    t_phase = time.monotonic()
    run_dp, trainer = scene["run_dp"], scene["trainer"]
    name = os.path.basename(run_dp)
    datasets = {"train": trainer.pipeline.datasets["rgb"],
                "test": trainer.pipeline.datasets["rgb_test"]}
    out = os.path.join(work, "eval_inline")
    try:
        reset_counters()
        preps0 = trunk.TC_PREPARATIONS
        t0 = time.monotonic()
        eval_all(run_dp, out, splits=("train", "test"), isolate="inline", device=dev)
        inline_s = time.monotonic() - t0
        got, plain_calls = read_counters()
        preps = trunk.TC_PREPARATIONS - preps0
    finally:
        disable_tf32()  # load_run applied the run's matmul_precision "high"
    chunks = sum(-(-len(item["rays"]) // CHUNK) for ds in datasets.values() for item in ds.data)
    want = _check_chunk_launches("eval_scene", got, plain_calls, chunks)
    check(preps == 1, f"eval_scene: {preps} K1 weight preparations for one load")

    results = {}
    for split in ("train", "test"):
        for kind in ("eval", "eval_semantic"):
            with open(os.path.join(out, name, kind, split, "results.json")) as f:
                results[f"{kind}/{split}"] = json.load(f)
    for key, tree in results.items():
        _check_results(key, tree)

    # the test image of the best checkpoint against the validation that
    # saved it (maybe_save_best keeps the first minimum of train/mae)
    best = min((v for v in trainer.val_history if "train/mae" in v),
               key=lambda v: v["train/mae"])
    test_name = datasets["test"].data[1]["name"]
    entry = results["eval/test"][test_name]
    best_line = {"psnr": entry["psnr"], "mae": entry["mae"]["mean"],
                 "validation_psnr": f"{best['test/psnr_0']:.2f}",
                 "validation_mae": f"{best['test/mae']:.3f}", "epoch": best["epoch"]}
    check(best_line["psnr"] == best_line["validation_psnr"]
          and best_line["mae"] == best_line["validation_mae"],
          f"test split against the best validation: {best_line}")

    partials, clouds = {}, {}
    for split, ds in datasets.items():
        for item in ds.data:
            with open(os.path.join(out, name, "partial", split, item["name"] + ".json")) as f:
                partial = json.load(f)
            partials[f"{split}/{item['name']}"] = partial["seconds"]
            rec = read_ply(os.path.join(out, name, "pointclouds", split,
                                        f"{item['name']}_epoch_{partial['step']}.ply"))
            clouds[f"{split}/{item['name']}"] = int(rec.shape[0])
            check(rec.shape[0] == len(item["rays"]),
                  f"{split}/{item['name']}: {rec.shape[0]} points for {len(item['rays'])} rays")

    # the test split again, one fresh worker process per image
    sub = os.path.join(work, "eval_subprocess")
    t0 = time.monotonic()
    eval_all(run_dp, sub, splits=("test",), isolate="subprocess", batch_images=1,
             stall_timeout_s=600.0, device=dev)
    subprocess_s = time.monotonic() - t0
    for kind in ("eval", "eval_semantic"):
        texts = []
        for root in (out, sub):
            with open(os.path.join(root, name, kind, "test", "results.json")) as f:
                texts.append(f.read())
        check(texts[0] == texts[1], f"{kind}: subprocess results.json differs from inline")

    parts = ("render", "psnr_ssim_dsm_mae", "semantic", "clouds")
    evaluated = [v for v in partials.values() if "psnr_ssim_dsm_mae" in v]
    line = {
        "phase": "eval_scene", "images": len(partials), "chunk": CHUNK,
        "launches": got, "expected_launches": want, "plain_calls": plain_calls,
        "preparations": preps, "best_vs_validation": best_line,
        "means": {k: results[k].get("PSNR (Mean)") or results[k].get("mIoU (Mean)")
                  for k in results},
        "test_results": {k: entry[k] for k in ("psnr", "ssim", "mae")},
        "semantic_test": {k: results["eval_semantic/test"][k]
                          for k in ("Semantic Accuracy (Mean)", "mIoU (Mean)")},
        "ply_points": clouds,
        "seconds_per_image": {k: sum(v[k] for v in evaluated) / len(evaluated) for k in parts},
        "seconds_by_image": partials,
        "inline_s": inline_s, "subprocess_test_split_s": subprocess_s,
        "subprocess_results_identical": True,
        "seconds": time.monotonic() - t_phase,
    }
    emit(line)
    return line


def _http(url: str, body: dict | None = None):
    """(status, content type, body bytes) of a GET (``body`` None) or a
    JSON POST."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def serve_view_phase(dev, scene: dict) -> dict:
    """train_scene's run A served by view name over HTTP: ``load_service``
    and ``serve_in_thread``; each view's PNG decodes to the served rgb
    exactly, the f16 arrays round-trip within 1e-3, a relit request changes
    the rgb, the error routes answer 400 and 404, the first 1,024 rays of a
    view agree with the CPU plain path, and a ``fast_sine`` service runs K1
    on poly5 and agrees with the plain poly5 version. Host ms per request by
    view, split into ``build_view_rays`` and the render."""
    import base64

    import numpy as np
    import torch

    from satnerf_torch.eval.render_view import build_view_rays
    from satnerf_torch.io.png import decode_png
    from satnerf_torch.models.field import Field
    from satnerf_torch.ops import trunk
    from satnerf_torch.render.renderer import render_image_chunked
    from satnerf_torch.serve.http_server import serve_in_thread
    from satnerf_torch.serve.service import RenderService, load_service

    t_phase = time.monotonic()
    run_dp = scene["run_dp"]
    reset_counters()
    preps0 = trunk.TC_PREPARATIONS
    t0 = time.monotonic()
    svc = load_service(run_dp, device=dev)  # renders the first view to warm up
    load_s = time.monotonic() - t0
    server, port = serve_in_thread(svc)
    url = f"http://127.0.0.1:{port}"
    try:
        names = svc.view_names()
        per_view, served = {}, {}
        for name in names:
            s0 = svc.stats()
            t0 = time.monotonic()
            status, ctype, body = _http(url + "/render", {"view": name})
            request_ms = (time.monotonic() - t0) * 1e3
            render_ms = (svc.stats()["render_seconds"] - s0["render_seconds"]) * 1e3
            check(status == 200 and ctype == "image/png", f"/render {name}: {status} {ctype}")
            served[name] = svc.render(name)
            want = (served[name]["rgb"] * 255).astype(np.uint8)
            check(np.array_equal(decode_png(body), want), f"{name}: PNG differs from the render")
            meta = svc.resolve_meta(name)
            t0 = time.monotonic()
            rays, _, w, h, _, _ = build_view_rays(svc.dataset, meta)
            build_ms = (time.monotonic() - t0) * 1e3
            per_view[name] = {"request_ms": request_ms, "build_view_rays_ms": build_ms,
                              "render_ms": render_ms,
                              "png_and_http_ms": request_ms - build_ms - render_ms,
                              "rays": int(rays.shape[0]),
                              "rays_per_s": rays.shape[0] / (request_ms / 1e3)}
        n0 = names[0]
        status, ctype, body = _http(url + "/render", {"view": n0, "output": "arrays"})
        check(status == 200 and ctype == "application/json", f"arrays: {status}")
        arr = json.loads(body)
        rgb16 = np.frombuffer(base64.b64decode(arr["rgb_f16_b64"]), np.float16)
        depth16 = np.frombuffer(base64.b64decode(arr["depth_f16_b64"]), np.float16)
        ref = served[n0]
        arrays_err = {
            "rgb": float(np.abs(rgb16.reshape(ref["rgb"].shape) - ref["rgb"]).max()),
            "depth_rel": float(np.abs(depth16.reshape(ref["depth"].shape) - ref["depth"]).max()
                               / max(1.0, float(np.abs(ref["depth"]).max()))),
        }
        check(max(arrays_err.values()) <= 1e-3, f"f16 arrays {arrays_err}")
        status, _, body = _http(url + "/render", {"view": n0, "output": "arrays",
                                                  "sun_elevation": 45.0})
        relit = np.frombuffer(base64.b64decode(json.loads(body)["rgb_f16_b64"]), np.float16)
        relit_diff = float(np.abs(relit.astype(np.float32) - rgb16.astype(np.float32)).mean())
        check(status == 200 and relit_diff > 1e-4, f"relit request: {status}, {relit_diff}")
        codes = {"escape": _http(url + "/render", {"view": "../x"})[0],
                 "inline_dict": _http(url + "/render", {"view": {"width": 4, "height": 4}})[0],
                 "unknown_view": _http(url + "/render", {"view": "NO_SUCH_VIEW"})[0],
                 "unknown_route": _http(url + "/nope")[0]}
        check(codes == {"escape": 400, "inline_dict": 400, "unknown_view": 400,
                        "unknown_route": 404}, f"error codes {codes}")
        status, _, body = _http(url + "/stats")
        stats = json.loads(body)
        # the warm-up, a request and a direct render per view, two array requests
        renders = 1 + 2 * len(names) + 2
        check(status == 200 and stats["requests"] == renders, f"/stats {stats}")
    finally:
        server.shutdown()
        server.server_close()
    got, plain_calls = read_counters()
    preps = trunk.TC_PREPARATIONS - preps0
    # every view is one chunk: K1 and K5 once per render
    check(got["field_fused"] == renders and got["composite"] == renders,
          f"serve_view launches {got} for {renders} renders")
    check(not any(plain_calls.values()), f"serve_view: a plain version ran: {plain_calls}")
    check(preps == 1, f"serve_view: {preps} K1 weight preparations")

    def against_cpu(service, name):
        """The first 1,024 rays of ``name`` on the CPU plain path."""
        rays, extras, *_ = build_view_rays(service.dataset, service.resolve_meta(name))
        params = {}
        for key, v in service.params.items():
            if isinstance(v, Field):
                cpu = Field(service.rcfg.field)
                cpu.load_state_dict({k: t.cpu() for k, t in v.state_dict().items()})
                params[key] = cpu
            else:
                params[key] = v.cpu()
        ref = render_image_chunked(params, service.rcfg, rays[:1024], extras[:1024],
                                   chunk=1024, device="cpu")
        got = service.render(name)
        return {"rgb": float(np.abs(got["rgb"].reshape(-1, 3)[:1024]
                                    - np.clip(ref["rgb"], 0, 1)).max()),
                "depth": float(np.abs(got["depth"].reshape(-1)[:1024] - ref["depth"]).max())}

    cpu_err = against_cpu(svc, n0)
    for k, tol in TOL_SERVE_CPU.items():
        check(cpu_err[k] <= tol, f"serve_view vs CPU {k} err {cpu_err[k]}")

    reset_counters()
    fast = RenderService.from_run(run_dp, fast_sine=True, device=dev)
    check(fast.rcfg.field.sin_impl == "poly5", "fast_sine service is not on poly5")
    fast.render(n0)
    fast_got, fast_plain = read_counters()
    check(fast_got["field_fused"] == 1 and not any(fast_plain.values()),
          f"fast_sine render: launches {fast_got}, plain {fast_plain}")
    fast_err = against_cpu(fast, n0)
    for k, tol in TOL_SERVE_CPU.items():
        check(fast_err[k] <= tol, f"fast_sine vs CPU poly5 {k} err {fast_err[k]}")

    ms = [v["request_ms"] for v in per_view.values()]
    line = {
        "phase": "serve_view", "views": names, "rays_per_view": per_view[n0]["rays"],
        "chunk": svc.chunk, "launches": got, "plain_calls": plain_calls, "preparations": preps,
        "renders": renders, "per_view": per_view, "request_ms_mean": sum(ms) / len(ms),
        "rays_per_s": sum(v["rays"] for v in per_view.values()) / (sum(ms) / 1e3),
        "load_service_s": load_s, "stats": stats, "arrays_max_err": arrays_err,
        "relit_mean_abs_rgb_change": relit_diff, "error_codes": codes,
        "cpu_plain_max_abs_err_1024_rays": cpu_err,
        "fast_sine": {"launches": fast_got, "cpu_poly5_max_abs_err_1024_rays": fast_err},
        "tol": {"cpu": TOL_SERVE_CPU, "arrays": 1e-3},
        "seconds": time.monotonic() - t_phase,
    }
    emit(line)
    return line


def viz_scene_phase(dev, scene: dict, work: str) -> dict:
    """``run_visualizer`` over train_scene's run A, its test and train
    splits: every visualizer's TIF for every image, the rgb TIF equal to the
    render of that image, K1 and K5 once per chunk of every image and no
    plain call; seconds per image in the render and in the visualizers
    (numpy and TIF writes)."""
    import numpy as np

    from satnerf_torch.device import disable_tf32
    from satnerf_torch.eval.loader import load_run
    from satnerf_torch.io.tiff import read_geotiff
    from satnerf_torch.render.renderer import render_image_chunked
    from satnerf_torch.viz import run_visualizer

    t_phase = time.monotonic()
    run_dp, trainer = scene["run_dp"], scene["trainer"]
    out = os.path.join(work, "viz_scene")
    datasets = {"test": trainer.pipeline.datasets["rgb_test"],
                "train": trainer.pipeline.datasets["rgb"]}
    try:
        reset_counters()
        t0 = time.monotonic()
        records = {split: run_visualizer(run_dp, out, split=split, chunk=CHUNK, device=dev)
                   for split in datasets}
        viz_s = time.monotonic() - t0
        got, plain_calls = read_counters()
        pipeline, params, rcfg, step = load_run(run_dp, device=dev)
    finally:
        disable_tf32()  # load_run applied the run's matmul_precision "high"
    chunks = sum(-(-len(item["rays"]) // CHUNK) for ds in datasets.values() for item in ds.data)
    want = _check_chunk_launches("viz_scene", got, plain_calls, chunks)

    tif_viz = [v for v in pipeline.visualizers() if v.save_as_tif]
    files, missing = 0, []
    for ds in datasets.values():
        for i in range(len(ds.data)):
            item = ds.image_item(i)
            for v in tif_viz:
                fp = v.tif_path(out, item["split"], item["name"], step)
                files += 1
                if not os.path.isfile(fp):
                    missing.append(os.path.relpath(fp, out))
    check(len(tif_viz) == 11 and not missing, f"viz_scene: missing TIFs {missing[:5]}")
    # the rgb TIF of the test view against that view's render
    item = datasets["test"].image_item(1)
    rgb_viz = [v for v in tif_viz if v._name() == "rgb"][0]
    tif, _ = read_geotiff(rgb_viz.tif_path(out, "test", item["name"], step))
    ref = render_image_chunked(params, rcfg, item["rays"], item["extras"], chunk=CHUNK,
                               device=dev)["rgb"]
    rgb_err = float(np.abs(tif - np.moveaxis(ref.reshape(item["h"], item["w"], 3), -1, 0)).max())
    check(rgb_err == 0.0, f"viz_scene: rgb TIF differs from the render by {rgb_err}")
    per_image = [r for recs in records.values() for r in recs]
    line = {
        "phase": "viz_scene", "images": len(per_image), "chunk": CHUNK, "step": step,
        "launches": got, "expected_launches": want, "plain_calls": plain_calls,
        "visualizers": len(pipeline.visualizers()), "tif_visualizers": len(tif_viz),
        "tif_files_checked": files, "rgb_tif_max_abs_err": rgb_err,
        "render_s_per_image": sum(r["render_s"] for r in per_image) / len(per_image),
        "visualizers_s_per_image": sum(r["viz_s"] for r in per_image) / len(per_image),
        "by_image": per_image, "run_visualizer_s": viz_s,
        "seconds": time.monotonic() - t_phase,
    }
    emit(line)
    return line


def _scene_run_toml(work: str, name: str, **run) -> str:
    """A run TOML on train_scene's scene and dataset cache."""
    from satnerf_torch.configs import write_toml

    fp = os.path.join(work, name)
    write_toml(fp, dict({
        "max_train_steps": DP_STEPS, "save_every_n_epochs": -1, "check_val_every_n_epoch": 1,
        "num_sanity_val_steps": 0, "seed": 0, "dataset_name": "SYN",
        "datasets_dp": os.path.join(work, "datasets"), "cache_dp": os.path.join(work, "cache"),
        "workspace_dp": os.path.join(work, name.replace(".toml", ""))}, **run))
    return fp


def dp_rank_main(run_fp: str, pipe_fp: str, out_fp: str, device: str) -> int:
    """One rank of train_dp (``--dp-rank RUN_TOML PIPELINE_TOML OUT_JSON
    DEVICE``, started with torchrun's environment): ``start_training`` joins
    the gloo group and trains on DEVICE; the rank writes its launches,
    losses, ms per step, collective seconds and validation to OUT_JSON."""
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.run.training import start_training

    disable_tf32()
    t0 = time.monotonic()
    pipeline, state, trainer = start_training(run_fp, pipe_fp, device=device,
                                              log_every=1, dist_backend="gloo")
    run_s = time.monotonic() - t0
    got, plain_calls = read_counters()
    layout = trainer.layout
    with open(out_fp, "w") as f:
        json.dump({
            "rank": layout.rank, "world": layout.world, "device": str(trainer.device),
            "launches": got, "plain_calls": plain_calls,
            "expected_launches": scene_expected_launches(trainer, DP_STEPS,
                                                         pipeline.ds_drop_step),
            "losses": [h["loss"] for h in trainer.history],
            "ms_per_step": trainer.ms_per_step, "steps_timed": trainer.steps_timed,
            "collective_s": dict(layout.seconds), "collective_calls": dict(layout.calls),
            "validation": trainer.val_history[-1], "run_dp": pipeline.cfg.run.run_dp,
            "validate_s": trainer.profiler.totals["validate"], "run_s": run_s,
        }, f)
    return 0


def _nccl_world_of_one(run_fp: str, dev):
    """``start_training`` as the one rank of an nccl group (torchrun's
    environment set in this process for the call)."""
    from satnerf_torch.parallel.multihost import free_port
    from satnerf_torch.run.training import start_training

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return start_training(run_fp, SCENE_PIPELINE, device=dev, log_every=1,
                              dist_backend="nccl")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def train_dp_phase(dev, work: str) -> dict:
    """Data parallelism on the card: the flagship TOML on train_scene's
    scene for DP_STEPS steps and one validation, (1) over two ranks on the
    one card (gloo: NCCL refuses two ranks on one device), each a process
    started with torchrun's environment, (2) in one process, (3) as the one
    rank of an nccl group. The ranks' and the nccl run's losses within rtol
    2e-5 of the one process at every step, their parameters within 1e-6,
    each rank's launches the schedule's (its rows of every step, its rows
    of every validation chunk) and no plain call; ms per step per rank and
    the collectives' share."""
    import torch

    from satnerf_torch.device import disable_tf32
    from satnerf_torch.parallel.multihost import free_port
    from satnerf_torch.run.training import start_training
    from satnerf_torch.train.checkpoint import export_params

    t_phase = time.monotonic()
    run2 = _scene_run_toml(work, "train_dp2.toml", data_parallel=2)
    outs = [os.path.join(work, f"dp_rank{r}.json") for r in range(2)]
    port = str(free_port())
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--dp-rank", run2,
         SCENE_PIPELINE, outs[r], str(dev)],
        cwd=REPO, env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                           MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.monotonic() - t0
    check([p.returncode for p in procs] == [0, 0],
          f"train_dp ranks exited {[p.returncode for p in procs]}: "
          + " | ".join(log[-2000:] for log in logs))
    ranks = []
    for fp in outs:
        with open(fp) as f:
            ranks.append(json.load(f))

    try:
        reset_counters()
        t0 = time.monotonic()
        _, state1, trainer1 = start_training(_scene_run_toml(work, "train_dp1.toml"),
                                             SCENE_PIPELINE, device=dev, log_every=1)
        one_s = time.monotonic() - t0
        one_launches, one_plain = read_counters()
        reset_counters()
        t0 = time.monotonic()
        _, state_n, trainer_n = _nccl_world_of_one(_scene_run_toml(work, "train_dp_nccl.toml"),
                                                   dev)
        nccl_s = time.monotonic() - t0
        nccl_launches, nccl_plain = read_counters()
    finally:
        disable_tf32()  # the runs' matmul_precision "high" allowed TF32
    check(not any(one_plain.values()) and not any(nccl_plain.values()),
          f"train_dp: a plain version ran: {one_plain} {nccl_plain}")
    check(one_launches == scene_expected_launches(trainer1, DP_STEPS,
                                                  trainer1.pipeline.ds_drop_step),
          f"train_dp one-process launches {one_launches}")
    check(nccl_launches == one_launches, f"nccl rank launches {nccl_launches}")
    want_losses = [h["loss"] for h in trainer1.history]
    check(len(want_losses) == DP_STEPS, f"{len(want_losses)} logged steps")

    def loss_rel(losses):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))

    want = export_params(state1.params)
    last = torch.load(os.path.join(ranks[0]["run_dp"], "ckpoints", "last.ckpt"),
                      map_location="cpu", weights_only=True)
    dp_param = max(float((last["state_dict"][k] - v).abs().max()) for k, v in want.items())
    nccl_params = export_params(state_n.params)
    nccl_param = max(float((nccl_params[k] - v).abs().max()) for k, v in want.items())
    rank_loss = [loss_rel(r["losses"]) for r in ranks]
    nccl_loss = loss_rel([h["loss"] for h in trainer_n.history])
    for r in ranks:
        check(r["world"] == 2 and r["device"] == "cuda:0", f"rank {r['rank']} on {r['device']}")
        check(r["launches"] == r["expected_launches"],
              f"rank {r['rank']} launches {r['launches']}, expected {r['expected_launches']}")
        check(not any(r["plain_calls"].values()), f"rank {r['rank']}: plain {r['plain_calls']}")
        check(len(r["losses"]) == DP_STEPS, f"rank {r['rank']}: {len(r['losses'])} steps")
    check(ranks[0]["losses"] == ranks[1]["losses"], "the ranks' losses differ")
    check(max(rank_loss) <= TOL_DP_LOSS and nccl_loss <= TOL_DP_LOSS,
          f"loss against one process: ranks {rank_loss}, nccl {nccl_loss}")
    check(dp_param <= TOL_DP_PARAM and nccl_param <= TOL_DP_PARAM,
          f"params against one process: ranks {dp_param}, nccl {nccl_param}")
    val1 = trainer1.val_history[-1]
    val_err = {k: abs(ranks[0]["validation"][k] - v) for k, v in val1.items()
               if isinstance(v, float)}
    check(all(math.isfinite(v) for v in val1.values() if isinstance(v, float))
          and "train/mae" in ranks[0]["validation"], f"validations {val1} {ranks[0]}")

    def per_step_ms(r):
        return {k: 1e3 * v / DP_STEPS for k, v in r["collective_s"].items()}

    line = {
        "phase": "train_dp", "steps": DP_STEPS, "ranks": 2, "backend": "gloo",
        "why_gloo": "two ranks share the one card, and NCCL refuses two ranks on one device",
        "launches_per_rank": [r["launches"] for r in ranks],
        "expected_launches_per_rank": ranks[0]["expected_launches"],
        "launches_one_process": one_launches, "launches_nccl_world_of_one": nccl_launches,
        "plain_calls": [r["plain_calls"] for r in ranks],
        "loss_max_rel_err": {"rank0": rank_loss[0], "rank1": rank_loss[1], "nccl": nccl_loss},
        "params_max_abs_err": {"ranks": dp_param, "nccl": nccl_param},
        "tol": {"loss_rel": TOL_DP_LOSS, "params_abs": TOL_DP_PARAM},
        "validation_abs_diff": val_err,
        "ms_per_step": {"rank0": ranks[0]["ms_per_step"], "rank1": ranks[1]["ms_per_step"],
                        "one_process": trainer1.ms_per_step, "nccl": trainer_n.ms_per_step},
        "collective_ms_per_step": {"rank0": per_step_ms(ranks[0]),
                                   "rank1": per_step_ms(ranks[1]),
                                   "nccl_host_issue": {k: 1e3 * v / DP_STEPS for k, v in
                                                       trainer_n.layout.seconds.items()}},
        "collective_share_of_step": {
            f"rank{r['rank']}": (per_step_ms(r).get("grads", 0.0)
                                 + per_step_ms(r).get("gather", 0.0)) / r["ms_per_step"]
            for r in ranks},
        "collective_calls": ranks[0]["collective_calls"],
        "grad_floats": int(sum(p.numel() for p in want.values())),
        "validate_s": {"rank0": ranks[0]["validate_s"],
                       "one_process": trainer1.profiler.totals["validate"]},
        "ranks_wall_s": ranks_s, "rank_run_s": [r["run_s"] for r in ranks],
        "one_process_s": one_s, "nccl_s": nccl_s,
        "not_scaling": "two ranks share one card's SMs: this shows the path and the "
                       "collectives' cost, not a speed-up",
        "seconds": time.monotonic() - t_phase,
    }
    emit(line)
    return line


def sweep_phase(dev, work: str) -> dict:
    """``run.automated_training.launch`` of a two-experiment TOML on the
    flagship pipeline (sc_lambda 0 and the TOML's 0.05), SWEEP_STEPS steps
    each, in this process: both runs leave ``last.ckpt``, a validation
    (DSM and visualizer TIFs) and no plain call."""
    import glob
    import shutil

    from satnerf_torch.device import disable_tf32
    from satnerf_torch.run.automated_training import launch

    t_phase = time.monotonic()
    cfg_dp = os.path.join(work, "sweep_cfgs")
    os.makedirs(cfg_dp)
    shutil.copy(SCENE_PIPELINE, os.path.join(cfg_dp, "rs_semantic.toml"))
    run_fp = _scene_run_toml(work, "sweep.toml", max_train_steps=SWEEP_STEPS)
    shutil.move(run_fp, os.path.join(cfg_dp, "run.toml"))
    exp_fp = os.path.join(cfg_dp, "experiment.toml")
    with open(exp_fp, "w") as f:
        f.write('run_cfg = "run.toml"\nexperiment_category = "smoke"\n'
                '[[experiments]]\npipeline_name = "rs_semantic.toml"\nid = "a"\n'
                "[experiments.pipeline]\nsc_lambda = 0.0\n"
                '[[experiments]]\npipeline_name = "rs_semantic.toml"\nid = "b"\n')
    try:
        reset_counters()
        t0 = time.monotonic()
        script = launch(exp_fp, os.path.join(work, "sweep_out"), workers=2, device=dev)
        launch_s = time.monotonic() - t0
        got, plain_calls = read_counters()
    finally:
        disable_tf32()
    check(not any(plain_calls.values()), f"sweep: a plain version ran: {plain_calls}")
    runs = sorted(glob.glob(os.path.join(work, "sweep", "_smoke", "experiment", "*")))
    names = [os.path.basename(r) for r in runs]
    check(len(runs) == 2 and any("_expa" in n for n in names)
          and any("_expb" in n for n in names), f"sweep runs {names}")
    for r in runs:
        check(os.path.isfile(os.path.join(r, "ckpoints", "last.ckpt")), f"{r}: no last.ckpt")
        check(glob.glob(os.path.join(r, "visualization", "train", "dsm", "*.tif"))
              and glob.glob(os.path.join(r, "visualization", "test", "rgb", "*.tif")),
              f"{r}: no validation")
    with open(script) as f:
        lines = [ln for ln in f.read().splitlines() if "CUDA_VISIBLE_DEVICES" in ln]
    check(len(lines) == 2, f"launch script lines {lines}")
    check(got["field_fused"] > 0 and got["composite"] > 0, f"sweep launches {got}")
    line = {"phase": "sweep", "experiments": 2, "steps_each": SWEEP_STEPS,
            "runs": [os.path.basename(r) for r in runs], "launches": got,
            "plain_calls": plain_calls, "launch_script_lines": lines,
            "launch_s": launch_s, "seconds": time.monotonic() - t_phase}
    emit(line)
    return line


def _create_dataset_cli(cfg_fp: str) -> dict:
    """``python -m satnerf_torch.data_prep.create_dataset cfg_fp`` in a fresh
    process -> {step file: (outcome, host seconds)} from its log."""
    import re

    out = subprocess.run([sys.executable, "-m", "satnerf_torch.data_prep.create_dataset",
                          cfg_fp], cwd=REPO, capture_output=True, text=True, timeout=900)
    check(out.returncode == 0, f"create_dataset {cfg_fp} exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    return {m[0]: (m[1], float(m[2]))
            for m in re.findall(r"step (\S+) (ran|skipped|disabled) in ([0-9.]+) s",
                                out.stdout)}


def prep_scene_phase(dev, work: str) -> dict:
    """A DFC2019 Track-3 distribution (``tests/torch_dfc_case.py``: PREP's
    14 views of the JAX_068 AOI from ``generate_scene``) made into a
    training dataset by the port's CLI (the adapter, cropping, the native
    BA, meta extraction, root.json, semantic masks cut on the cropped
    grid), a second run skipping every step; ``start_training`` on the
    flagship TOML as it is for PREP_STEPS steps with the sanity validation
    and the one at the run's end (PSNR, SSIM, DSM MAE against the GT DSM the
    adapter georegistered), its launches by the schedule and no plain
    version; the eval battery inline over the predefined test split."""
    import glob
    import importlib.util

    import torch

    from satnerf_torch.configs import write_toml
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.eval.eval import eval_all
    from satnerf_torch.io.json_io import read_json
    from satnerf_torch.io.tiff import read_geotiff_profile
    from satnerf_torch.ops import trunk
    from satnerf_torch.pipelines.base import Pipeline
    from satnerf_torch.run.training import start_training

    # the distribution writer the CPU tests share (by path: the card
    # machine's environment may hold another package named "tests")
    spec = importlib.util.spec_from_file_location(
        "torch_dfc_case", os.path.join(REPO, "tests", "torch_dfc_case.py"))
    dfc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dfc)

    t_phase = time.monotonic()
    t0 = time.monotonic()
    dist = dfc.write_distribution(os.path.join(work, "raw"), **PREP)
    distribution_s = time.monotonic() - t0
    out_dp = os.path.join(work, "datasets", dfc.AOI)
    crop_fp = dfc.write_config(os.path.join(work, "crop.toml"), dfc.general(dist, out_dp),
                               dfc.PREP_STEPS[:2])
    full_fp = dfc.write_config(os.path.join(work, "dataset.toml"),
                               dfc.general(dist, out_dp, os.path.join(work, "masks")),
                               dfc.PREP_STEPS)
    # the masks are annotated on the cropped grid: a run up to the cropping
    # step, the masks cut at each view's window, then the whole config
    t0 = time.monotonic()
    crop_steps = _create_dataset_cli(crop_fp)
    windows = dfc.crop_masks(dist, out_dp, os.path.join(work, "masks"))
    steps = _create_dataset_cli(full_fp)
    prep_s = time.monotonic() - t0
    check([s["file"] for s in dfc.PREP_STEPS[:2]] == list(crop_steps)
          and all(o == "ran" for o, _ in crop_steps.values()), f"crop run {crop_steps}")
    check(list(steps) == [s["file"] for s in dfc.PREP_STEPS]
          and [o for o, _ in steps.values()] == ["skipped"] * 2 + ["ran"] * 4,
          f"create_dataset steps {steps}")
    t0 = time.monotonic()
    again = _create_dataset_cli(full_fp)
    again_s = time.monotonic() - t0
    check(all(o == "skipped" for o, _ in again.values()) and len(again) == 6,
          f"the lazy re-run ran a step: {again}")

    root = read_json(os.path.join(out_dp, "root.json"))
    predefined = ["JAX_068_002_RGB.json", "JAX_068_012_RGB.json"]
    check(len(root["train_split"]) == 12 and root["test_split"] == predefined,
          f"splits {root['train_split']} / {root['test_split']}")
    check(root.get("points3d_fp") == "pts3d.npy" and root["img_dp"] == "images_cropped"
          and root.get("semantic_cls_labels", {}).get("4") == "cars", f"root.json {root}")
    gt = read_geotiff_profile(os.path.join(out_dp, root["dsm_tif_fp"]))
    check(gt.transform is not None and gt.epsg == 32617, f"GT DSM profile {gt}")
    n_kp = {}
    for name in root["train_split"]:
        meta = read_json(os.path.join(out_dp, "metas", name))
        n_kp[name[:-5]] = len(meta.get("keypoints", {}).get("2d_coordinates", []))
    check(all(n > 0 for n in n_kp.values()), f"train views without keypoints: {n_kp}")
    ba = read_json(os.path.join(out_dp, "ba_native", "ba_stats.json"))
    check(ba["mean_reproj_px"] < 1.0, f"BA mean reprojection {ba['mean_reproj_px']} px")
    sizes = {n: [w, h] for n, (_, _, w, h) in windows.items()}

    # ---- train on it ----
    run_fp = os.path.join(work, "run.toml")
    write_toml(run_fp, {
        "max_train_steps": PREP_STEPS, "check_val_every_n_epoch": 1,
        "num_sanity_val_steps": 1, "seed": 0, "dataset_name": dfc.AOI,
        "datasets_dp": os.path.join(work, "datasets"), "cache_dp": os.path.join(work, "cache"),
        "workspace_dp": os.path.join(work, "training")})
    load_s = []
    load = Pipeline.load_datasets

    def timed_load(self, *args, **kwargs):
        t = time.monotonic()
        load(self, *args, **kwargs)
        load_s.append(time.monotonic() - t)

    try:
        Pipeline.load_datasets = timed_load
        reset_counters()
        preps0 = trunk.TC_PREPARATIONS
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        pipeline, state, trainer = start_training(run_fp, PIPELINE_TOML, device=dev,
                                                  log_every=1)
        run_s = time.monotonic() - t0
        got, plain_calls = read_counters()
        preps = trunk.TC_PREPARATIONS - preps0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        Pipeline.load_datasets = load
        disable_tf32()  # the run's matmul_precision "high" allowed TF32
    run_dp = pipeline.cfg.run.run_dp
    ds_drop = pipeline.ds_drop_step
    check(state.step == PREP_STEPS, f"prep_scene run ended at step {state.step}")
    check(len(load_s) == 1, f"datasets loaded {len(load_s)} times")
    check(pipeline.datasets["depth"].combined["rays"].shape[0] > 0, "no depth rays")
    want = scene_expected_launches(trainer, PREP_STEPS, ds_drop)
    check(got == want, f"prep_scene launches {got}, expected {want}")
    check(not any(plain_calls.values()), f"prep_scene: a plain version ran: {plain_calls}")
    n_val = len(trainer.val_history)
    check(n_val == 2 and trainer.val_history[0]["sanity"]
          and not trainer.val_history[-1]["sanity"], f"validations {trainer.val_history}")
    check(preps == PREP_STEPS + n_val, f"K1 weight preparations {preps}")
    hist = trainer.history
    bad = [h["step"] for h in hist if not all(math.isfinite(v) for v in h.values())]
    check(len(hist) == PREP_STEPS and not bad, f"non-finite loss terms at steps {bad[:5]}")
    mse_first, mse_last = _rgb_mse_falls(hist, 20)  # as train_scene holds it
    val = trainer.val_history[-1]
    val_keys = ["train/psnr", "train/mae", "test/psnr", "test/mae"] + [
        k for k in val if "/ssim_" in k]
    check(all(k in val and math.isfinite(val[k]) for k in val_keys), f"validation {val}")
    check(all(val[k] <= 1.0 for k in val if "/ssim_" in k), f"SSIM above 1: {val}")
    check(os.path.isfile(os.path.join(run_dp, "ckpoints", "best.ckpt")), "no best.ckpt")

    # ---- the eval battery over the predefined test split ----
    rgb_test = pipeline.datasets["rgb_test"]
    check([item["name"] for item in rgb_test.data][1:] == [n[:-5] for n in predefined],
          f"test split {[item['name'] for item in rgb_test.data]}")
    out = os.path.join(work, "eval")
    try:
        reset_counters()
        t0 = time.monotonic()
        eval_all(run_dp, out, splits=("test",), isolate="inline", device=dev)
        eval_s = time.monotonic() - t0
        eval_got, eval_plain = read_counters()
    finally:
        disable_tf32()  # load_run applied the run's matmul_precision "high"
    chunks = sum(-(-len(item["rays"]) // CHUNK) for item in rgb_test.data)
    _check_chunk_launches("prep_scene eval", eval_got, eval_plain, chunks)
    name = os.path.basename(run_dp)
    results = {}
    for kind in ("eval", "eval_semantic"):
        with open(os.path.join(out, name, kind, "test", "results.json")) as f:
            results[kind] = json.load(f)
    for kind, tree in results.items():
        _check_results(kind, tree)
    parts = ("render", "psnr_ssim_dsm_mae", "semantic", "clouds")
    partials = []  # the prepended train view is rendered, not scored
    for fp in sorted(glob.glob(os.path.join(out, name, "partial", "test", "*.json"))):
        with open(fp) as f:
            partials.append(json.load(f)["seconds"])
    check(len(partials) == len(rgb_test.data)
          and all(any(k in p for p in partials) for k in parts),
          f"eval partials {partials}")
    prof = trainer.profiler
    line = {
        "phase": "prep_scene", "distribution": PREP, "steps": PREP_STEPS,
        "cropped_sizes": sizes, "step_seconds_host": {k: s for k, (_, s) in steps.items()},
        "crop_run_seconds_host": {k: s for k, (_, s) in crop_steps.items()},
        "rerun_all_skipped": True, "rerun_s": again_s,
        "rerun_step_seconds_host": {k: s for k, (_, s) in again.items()}, "prep_s": prep_s,
        "distribution_s": distribution_s,
        "ba": {k: ba[k] for k in ("n_tracks", "n_obs", "mean_reproj_px", "median_reproj_px")},
        "keypoints_per_train_view": n_kp, "splits": [len(root["train_split"]),
                                                     len(root["test_split"])],
        "dataset_load_s": load_s[0],
        "rays": {k: int(pipeline.datasets[k].combined["rays"].shape[0])
                 for k in ("rgb", "rgb_test", "depth")},
        "depth_drop_step": ds_drop, "launches": got, "expected_launches": want,
        "plain_calls": plain_calls, "preparations": preps, "validations": n_val,
        "rgb_mse_first20_mean": mse_first, "rgb_mse_last20_mean": mse_last,
        "loop_ms_per_step_host": trainer.ms_per_step,
        "validate_s": prof.totals["validate"] / prof.counts["validate"],
        "last_validation": val, "peak_memory_gb": peak_gb, "run_s": run_s,
        "eval_launches": eval_got, "eval_test_images": len(partials),
        "eval_test": {k: results["eval"].get(k) for k in results["eval"] if "Mean" in k},
        "eval_semantic_test": {k: results["eval_semantic"][k]
                               for k in ("Semantic Accuracy (Mean)", "mIoU (Mean)")},
        "eval_seconds_per_image": {k: sum(p[k] for p in partials if k in p)
                                   / sum(k in p for p in partials) for k in parts},
        "eval_s": eval_s, "seconds": time.monotonic() - t_phase,
    }
    emit(line)
    return line


def quality_tools_phase(dev, work: str) -> dict:
    """The quality tools on the card: ``tools.ours_train_eval`` at full
    width (QUALITY_SCENE, QUALITY_STEPS steps in bf16, curve evals at
    QUALITY_EVAL_AT): every results JSON's metrics finite, PSNR at the last
    horizon above the first, the launches of K1, K2, K4, K5 and K5's
    backward by the step and validation schedule plus K1 and K5 once per
    eval chunk, no plain version; ``tools.sin_swap_eval`` of the run under
    QUALITY_SINS, each engine's renders through K1 under its ``SinMode``;
    ``tools.quality_gate`` on the results JSON."""
    import contextlib
    import io

    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.tools import ours_train_eval, quality_gate, sin_swap_eval

    t_phase = time.monotonic()
    scene = os.path.join(work, "datasets", "SYN_Q")
    generate_scene(scene, **QUALITY_SCENE)
    out = os.path.join(work, "quality", "poly_s0")
    try:
        with recording_fit() as fits:
            reset_counters()
            t0 = time.monotonic()
            rc = ours_train_eval.main([
                scene, out, "--steps", str(QUALITY_STEPS), "--batch", str(TRAIN_RAYS),
                "--n-samples", "64", "--units", "512", "--dtype", "bfloat16",
                "--eval-at", ",".join(map(str, QUALITY_EVAL_AT)), "--device", dev.type])
            run_s = time.monotonic() - t0
            got, plain_calls = read_counters()
    finally:
        disable_tf32()
    check(rc == 0 and len(fits) == 1, f"ours_train_eval exited {rc}")
    trainer = fits[0][0]
    results = {}
    for step in QUALITY_EVAL_AT + (QUALITY_STEPS,):
        name = "results.json" if step == QUALITY_STEPS else f"results_step{step}.json"
        with open(os.path.join(out, name)) as f:
            r = json.load(f)
        check(all(math.isfinite(r[k]) for k in ("psnr", "ssim", "mae", "acc", "miou")),
              f"quality_tools {name}: {r}")
        results[step] = {k: r[k] for k in ("psnr", "ssim", "mae", "acc", "miou")}
    first, last = results[QUALITY_EVAL_AT[0]]["psnr"], results[QUALITY_STEPS]["psnr"]
    check(last > first, f"test PSNR did not rise: step {QUALITY_EVAL_AT[0]} {first}, "
                        f"step {QUALITY_STEPS} {last}")
    rgb_test = trainer.pipeline.datasets["rgb_test"]
    eval_chunks = (len(QUALITY_EVAL_AT) + 1) * sum(  # evaluate_ours: 8,192-ray chunks
        -(-len(item["rays"]) // 8192) for item in rgb_test.data[1:])
    want = scene_expected_launches(trainer, QUALITY_STEPS, trainer.pipeline.ds_drop_step)
    want["field_fused"] += eval_chunks
    want["composite"] += eval_chunks
    check(got == want, f"quality_tools launches {got}, expected {want}")
    check(not any(plain_calls.values()), f"quality_tools: a plain version ran: {plain_calls}")

    # the same checkpoint under each engine: K1 under that SinMode, no plain field
    run_dp = trainer.cfg.run.run_dp
    swap_dp = os.path.join(work, "sinswap")
    try:
        reset_counters()
        t0 = time.monotonic()
        rc = sin_swap_eval.main([run_dp, "--sins", ",".join(QUALITY_SINS), "--out", swap_dp,
                                 "--device", dev.type])
        swap_s = time.monotonic() - t0
        swap_got, swap_plain = read_counters()
    finally:
        disable_tf32()  # load_run applied the run's matmul_precision "high"
    with open(os.path.join(swap_dp, "summary.json")) as f:
        rows = json.load(f)
    test_chunks = sum(-(-len(item["rays"]) // 16384) for item in rgb_test.data[1:])
    check(rc == 0 and [r["eval_sin"] for r in rows] == list(QUALITY_SINS),
          f"sin_swap_eval exited {rc}: {rows}")
    check(all(r["field_kernel_launches"] == test_chunks and r["plain_field_calls"] == 0
              and all(math.isfinite(r[k]) for k in ("psnr", "ssim", "mae")) for r in rows),
          f"sin_swap_eval rows {rows}")
    _check_chunk_launches("quality_tools sin_swap", swap_got, swap_plain,
                          len(QUALITY_SINS) * test_chunks)

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = quality_gate.main([os.path.dirname(out), "--engines", "poly", "--seeds", "0"])
    table = text.getvalue()
    check(rc == 0 and "| poly seed 0 |" in table and "DECISION" in table,
          f"quality_gate exited {rc}: {table}")
    line = {
        "phase": "quality_tools", "scene": QUALITY_SCENE, "steps": QUALITY_STEPS,
        "eval_at": QUALITY_EVAL_AT, "results": results, "launches": got,
        "expected_launches": want, "plain_calls": plain_calls,
        "depth_drop_step": trainer.pipeline.ds_drop_step,
        "loop_ms_per_step_host": trainer.ms_per_step, "ours_train_eval_s": run_s,
        "sin_swap": rows, "sin_swap_launches": swap_got, "sin_swap_s": swap_s,
        "quality_gate": table.strip().splitlines(),
        "seconds": time.monotonic() - t_phase,
    }
    emit(line)
    return {**line, "fit": fits[0], "scene_dp": scene}


@contextlib_contextmanager
def recording_fit():
    """Within: every ``Trainer.fit`` appends (trainer, the state it returns)
    to the yielded list."""
    from satnerf_torch.train.loop import Trainer

    fits = []
    fit = Trainer.fit

    def recorded_fit(self, *args, **kwargs):
        state = fit(self, *args, **kwargs)
        fits.append((self, state))
        return state

    Trainer.fit = recorded_fit
    try:
        yield fits
    finally:
        Trainer.fit = fit


def audit_batch(pipeline, n: int, n_depth: int, seed: int, dev) -> dict:
    """``n`` rays of the pipeline's train split and min(``n_depth``, its tie
    points) depth rays, each drawn without replacement from ``seed``."""
    import numpy as np
    import torch

    from satnerf_torch.train.data import DEPTH_KEYS, TRAIN_KEYS, device_store, gather_batch

    rng = np.random.default_rng(seed)
    batch = {}
    for split, keys, rows, prefix in (("rgb", TRAIN_KEYS, n, ""),
                                      ("depth", DEPTH_KEYS, n_depth, "depth_")):
        comb = pipeline.datasets[split].combined
        total = int(comb["rays"].shape[0])
        idx = np.sort(rng.choice(total, size=min(rows, total), replace=False))
        store = device_store(comb, keys, device=dev)
        batch.update(gather_batch(store, torch.from_numpy(idx).to(dev), prefix=prefix))
    return batch


def _upstream_hooks(out, store: dict) -> None:
    """Under autograd: the gradient that reaches each output of ``out`` (a
    dict, or a sequence keyed by position) in the backward lands in
    ``store``."""
    import torch

    if not torch.is_grad_enabled():
        return
    for k, v in (out.items() if isinstance(out, dict) else enumerate(out)):
        if v.requires_grad:
            v.register_hook(lambda g, k=k: None if g is None
                            else store.__setitem__(k, g.detach()))


@contextlib_contextmanager
def _audit_hooks(fine_depths: list | None = None):
    """Within: the renderer's field evaluations (inputs, outputs and the
    gradients that reach the outputs), K5's inputs, weights and output
    gradients of each composite, and the hierarchical pass's inverse-CDF
    depths are recorded; given ``fine_depths`` (another step's record), the
    hierarchical pass takes those depths in place of its own draws."""
    from satnerf_torch.render import renderer

    rec = {"field": [], "field_upstream": [], "weights": [], "composite": [],
           "composite_upstream": [], "fine_depths": []}
    eval_field, composite, sample_pdf = (renderer._eval_field, renderer.composite,
                                         renderer.sample_pdf)

    def eval_recorded(*args):
        out = eval_field(*args)
        rec["field"].append((args, {k: v.detach() for k, v in out.items()}))
        rec["field_upstream"].append({})
        _upstream_hooks(out, rec["field_upstream"][-1])
        return out

    def composite_recorded(*args):
        out = composite(*args)
        rec["weights"].append(out[0].detach())
        rec["composite"].append(tuple(a.detach() for a in args))
        rec["composite_upstream"].append({})
        _upstream_hooks(out, rec["composite_upstream"][-1])
        return out

    def sample_pdf_recorded(bins, weights, *args, **kwargs):
        z = (sample_pdf(bins, weights, *args, **kwargs) if fine_depths is None
             else fine_depths[len(rec["fine_depths"])].to(bins.dtype))
        rec["fine_depths"].append(z.detach())
        return z

    renderer._eval_field, renderer.composite = eval_recorded, composite_recorded
    renderer.sample_pdf = sample_pdf_recorded
    try:
        yield rec
    finally:
        renderer._eval_field, renderer.composite = eval_field, composite
        renderer.sample_pdf = sample_pdf


@contextlib_contextmanager
def plain_versions():
    """Within: K1, K2, K4 and K5 (with its backward) run their plain versions
    on CUDA tensors, through the same autograd functions and packed weights
    (``_reference_forward``, ``heads_backward_reference``,
    ``trunk_backward_reference``, ``composite_reference``), with TF32 off."""
    import torch

    from satnerf_torch.device import disable_tf32
    from satnerf_torch.ops import composite as comp
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk
    from satnerf_torch.render import renderer

    saved = (ff._forward, ff.heads_backward, trunk.trunk_backward, renderer.composite)

    def trunk_backward(spec, x, packed, acts, g_shared, need_gx=True):
        return trunk.trunk_backward_reference(spec, x, packed, acts, g_shared)

    def heads_backward(spec, shared, aux, g_out, packed, need_aux=True):
        return ff.heads_backward_reference(spec, shared, aux, g_out, packed)

    ff._forward, ff.heads_backward = ff._reference_forward, heads_backward
    trunk.trunk_backward, renderer.composite = trunk_backward, comp.composite_reference
    torch.set_float32_matmul_precision("highest")
    disable_tf32()
    try:
        yield
    finally:
        ff._forward, ff.heads_backward, trunk.trunk_backward, renderer.composite = saved


def _named_grads(params: dict) -> dict:
    out = {}
    for key in ("field", "fine"):
        if params.get(key) is not None:
            out.update({f"{key}.{k}": p.grad.detach()
                        for k, p in params[key].named_parameters()})
    for key in ("t", "t_s"):
        if params.get(key) is not None:
            out[key] = params[key].grad.detach()
    return out


def audit_engine(pipeline, params: dict, step: int, batch: dict, dev, dtype: str,
                 plain: bool, layered: bool = False, precision: str | None = None,
                 fine_depths: list | None = None) -> dict:
    """One training step of the pipeline's depth step config at ``step`` on
    copies of ``params``, its jitter drawn from AUDIT_SEED, in ``dtype``:
    through the kernels (library matmuls at the run's precision) or, with
    ``plain``, through their plain versions (``plain_versions``); with
    ``layered`` too, through the layer-by-layer field (the JAX package's XLA
    path: in bf16 the trunk's products in bf16, the heads in f32) in
    AUDIT_LAYERED_TILES checkpointed tiles. ``precision`` replaces the run's
    matmul precision for the kernels; ``fine_depths`` (another step's record)
    replaces the hierarchical pass's draws. -> ``recorded_step``'s record
    of the step on the copies."""
    import dataclasses

    import torch

    from satnerf_torch.run.training import apply_matmul_precision
    from satnerf_torch.train.data import EpochSampler
    from satnerf_torch.train.state import create_train_state

    cfg = pipeline.cfg
    spe = EpochSampler(len(pipeline.datasets["rgb"]), cfg.pipeline.batch_size).steps_per_epoch
    scfg = pipeline.step_config(spe, with_depth=True, device=dev)
    rcfg = dataclasses.replace(scfg.render, compute_dtype=dtype)
    if layered:
        rcfg = dataclasses.replace(rcfg, remat_chunks=AUDIT_LAYERED_TILES,
                                   field=dataclasses.replace(rcfg.field, trunk_impl="xla"))
    scfg = dataclasses.replace(scfg, render=rcfg)
    prm = copy_params(params, dev)
    if dtype == "float64":
        # the truth: the plain step on the same parameter values in f64; the
        # batch, its jitter and the sampled points stay the f32 step's
        check(plain, "trained_audit: float64 runs the plain versions only")
        prm = {k: v.double() if k in ("field", "fine")
               else v.detach().double().requires_grad_(True) for k, v in prm.items()}
    state = create_train_state(prm, cfg.pipeline.learnrate, cfg.pipeline.lr_scheduler, spe)
    state.step = int(step)
    if not plain:
        precision = precision or cfg.run.matmul_precision
        apply_matmul_precision(precision)
        # as a fresh process of the run has it, whatever this one set before
        torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    return recorded_step(scfg, state, batch, dev, plain, fine_depths)


def recorded_step(scfg, state, batch: dict, dev, plain: bool,
                  fine_depths: list | None = None) -> dict:
    """One training step of ``state`` under ``scfg``, its jitter drawn from
    AUDIT_SEED, through the kernels or, with ``plain``, their plain versions
    (``plain_versions``); the hierarchical pass at ``fine_depths`` where they
    are given -> loss terms, every gradient, the field evaluations (inputs,
    outputs, output gradients) and which of the step's fields made each
    ("field_keys": "field" or "fine"), K5's inputs, weights and output
    gradients, and the hierarchical pass's depths."""
    import torch

    from satnerf_torch.train.step import build_train_step

    gen = torch.Generator(device=dev).manual_seed(AUDIT_SEED)
    with plain_versions() if plain else contextlib_nullcontext(), \
            _audit_hooks(fine_depths) as rec:
        state, metrics = build_train_step(scfg)(state, batch, gen)
    torch.cuda.synchronize()
    keys = [next(k for k in ("field", "fine") if state.params.get(k) is args[0])
            for args, _ in rec["field"]]
    return {"loss": {k: float(v) for k, v in metrics.items()},
            "grad": _named_grads(state.params), "field": rec["field"], "field_keys": keys,
            "weights": rec["weights"], "composite": rec["composite"],
            "field_upstream": rec["field_upstream"],
            "composite_upstream": rec["composite_upstream"],
            "fine_depths": rec["fine_depths"], "fcfg": scfg.render.field}


def _audit_errors(got: dict, ref: dict) -> dict:
    """Per tensor: loss terms as TOL_STEP_LOSS measures them, the rest by
    ``rel_err``; the field evaluations in the order the step made them."""
    check(set(got["loss"]) == set(ref["loss"]) and len(got["field"]) == len(ref["field"])
          and len(got["weights"]) == len(ref["weights"]),
          f"trained_audit: {len(got['field'])} field evaluations and "
          f"{len(got['weights'])} composites against {len(ref['field'])}, "
          f"{len(ref['weights'])}")
    field = {}
    for i, (key, (_, o), (_, r)) in enumerate(zip(got["field_keys"], got["field"],
                                                  ref["field"])):
        field.update({f"eval{i}.{key}.{k}": rel_err(o[k], v)
                      for k, v in r.items() if v.numel()})
    return {
        "loss": {k: abs(got["loss"][k] - v) / max(1.0, abs(v)) for k, v in ref["loss"].items()},
        "field": field,
        "weights": {f"composite{i}": rel_err(a, b)
                    for i, (a, b) in enumerate(zip(got["weights"], ref["weights"]))},
        "grad": {k: rel_err(got["grad"][k], v) for k, v in ref["grad"].items()},
    }


# trained_audit's comparisons: {name: (engine, the engine it is held against)}
AUDIT_PAIRS = {"float32": ("float32", "plain_float32"),
               "bfloat16": ("bfloat16", "plain_bfloat16"),
               "bfloat16_vs_float32": ("bfloat16", "plain_float32"),
               "plain_bfloat16_vs_float32": ("plain_bfloat16", "plain_float32"),
               "layered_bfloat16_vs_float32": ("layered_bfloat16", "plain_float32"),
               "layered_float32_vs_float32": ("layered_float32", "plain_float32"),
               "float32_vs_float64": ("float32", "plain_float64"),
               "plain_float32_vs_float64": ("plain_float32", "plain_float64")}


def trained_audit(pipeline, params: dict, step: int, n_rays: int, n_depth: int, dev) -> dict:
    """The kernels against their plain versions at ``params`` (a trained
    state of ``pipeline``'s run) on one batch of its scene, in f32 and in
    bf16 -> {"float32" | "bfloat16": {"loss" | "field" | "weights" | "grad":
    {name: error}}}, held to TOL_AUDIT; beside them, unbarred, how far bf16
    takes the kernels, their plain versions and the layer-by-layer field
    from the plain f32 step ("bfloat16_vs_float32",
    "plain_bfloat16_vs_float32", "layered_bfloat16_vs_float32"), and how far
    apart two plain f32 steps are, the layer-by-layer field's and the
    kernels' plain versions' ("layered_float32_vs_float32"), and, unbarred
    too, how far the f32 kernels and their f32 plain versions lie from the
    plain step in f64 ("float32_vs_float64", "plain_float32_vs_float64":
    the float64 column). K1's outputs are compared on the points the
    kernels' step evaluated, each by the plain version of the field that
    made it (coarse or fine). In a hierarchical pipeline every step but the
    f32 kernels' own takes that step's inverse-CDF depths: each step draws
    them alike from its own coarse weights, which differ by the engine's
    error, and the draw magnifies that by the inverse of a bin's
    probability, so that on their own depths the fine passes of two engines
    would be compared at other points."""
    import torch

    from satnerf_torch.render import renderer

    batch = audit_batch(pipeline, n_rays, n_depth, AUDIT_SEED, dev)
    kept = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    runs = {}
    fields = copy_params(params, dev)
    fields64 = {k: v.double() for k, v in copy_params(params, dev).items()
                if k in ("field", "fine")}

    def plain(dtype, kernel_run, f64=False, **kw):
        # the plain step at the f32 kernels' fine depths, then each field
        # evaluation of the kernels' step by the plain version of its own
        # field on the kernels' points, not on the plain step's
        run = audit_engine(pipeline, params, step, batch, dev, dtype, plain=True,
                           fine_depths=depths, **kw)
        with plain_versions(), torch.no_grad():
            run["field"] = [
                (args, renderer._eval_field(fields64[key], run["fcfg"], torch.float64,
                                            *args[3:])
                 if f64 else renderer._eval_field(fields[key], run["fcfg"], *args[2:]))
                for key, (args, _) in zip(kernel_run["field_keys"], kernel_run["field"])]
        run["field_keys"] = kernel_run["field_keys"]
        return run

    try:
        runs["float32"] = audit_engine(pipeline, params, step, batch, dev, "float32",
                                       plain=False)
        depths = runs["float32"]["fine_depths"]
        runs["bfloat16"] = audit_engine(pipeline, params, step, batch, dev, "bfloat16",
                                        plain=False, fine_depths=depths)
        for dtype in ("float32", "bfloat16"):
            runs[f"plain_{dtype}"] = plain(dtype, runs[dtype])
        # the run's matmul precision reaches no product of the kernels' step
        highest = audit_engine(pipeline, params, step, batch, dev, "float32", plain=False,
                               precision="highest")
        same = highest["loss"] == runs["float32"]["loss"] and all(
            torch.equal(v, runs["float32"]["grad"][k]) for k, v in highest["grad"].items())
        del highest
        for dtype in ("float32", "bfloat16"):
            runs[f"layered_{dtype}"] = plain(dtype, runs[dtype], layered=True)
        runs["plain_float64"] = plain("float64", runs["float32"], f64=True)
    finally:  # the caller's TF32 setting, as it was
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = kept
    out = {"rays": int(batch["rays"].shape[0]), "depth_rays": int(batch["depth_rays"].shape[0]),
           "step": int(step), "float32_highest_bitwise": same,
           "field_evaluations": {k: runs["float32"]["field_keys"].count(k)
                                 for k in ("field", "fine")},
           "fine_passes_replayed": len(runs["float32"]["fine_depths"])}
    for name, (a, b) in AUDIT_PAIRS.items():
        out[name] = _audit_errors(runs[a], runs[b])
    return out


def audit_failures(audit: dict, bf16_yardstick: bool = False) -> list:
    """Every error of a ``trained_audit`` beyond its TOL_AUDIT bar; with
    ``bf16_yardstick``, a bf16 gradient beyond its bar passes where the bf16
    kernels lie no farther from the plain f32 step than the plain bf16 step
    does, plus that bar (HIER_AUDIT says why)."""
    bad = []
    for engine, bars in TOL_AUDIT.items():
        for group, bar in bars.items():
            yard = bf16_yardstick and engine == "bfloat16" and group == "grad"
            bad += [f"{engine} {group} {k}: {e}" for k, e in audit[engine][group].items()
                    if not (e <= bar or yard and audit["bfloat16_vs_float32"][group][k]
                            <= audit["plain_bfloat16_vs_float32"][group][k] + bar)]
    return bad


def audit_worst(audit: dict) -> dict:
    return {e: {g: max(v.values()) for g, v in groups.items()}
            for e, groups in audit.items() if e in AUDIT_PAIRS}


def trained_audit_phase(dev, quality: dict, work: str) -> dict:
    """``trained_audit`` at the field quality_tools trained (bf16, its last
    step) and at one trained the same way in f32 for AUDIT_F32_STEPS steps;
    the line prints every error, then any beyond its bar fails the run."""
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.tools import ours_train_eval

    t_phase = time.monotonic()
    out = os.path.join(work, "quality", "f32_s0")
    try:
        with recording_fit() as fits:
            rc = ours_train_eval.main([
                quality["scene_dp"], out, "--steps", str(AUDIT_F32_STEPS),
                "--batch", str(TRAIN_RAYS), "--n-samples", "64", "--units", "512",
                "--dtype", "float32", "--device", dev.type])
    finally:
        disable_tf32()
    check(rc == 0 and len(fits) == 1, f"ours_train_eval f32 exited {rc}")
    audits = {}
    for name, (trainer, state) in (("bfloat16_run", quality["fit"]), ("float32_run", fits[0])):
        audits[name] = trained_audit(trainer.pipeline, state.params, state.step,
                                     TRAIN_RAYS, TRAIN_RAYS, dev)
    t_hier = time.monotonic()
    trainer, state = quality["fit"]
    pipeline, params = hier_audit_case(trainer, dev)
    audits["hierarchical"] = hier = trained_audit(pipeline, params, state.step, TRAIN_RAYS,
                                                  TRAIN_RAYS, dev)
    check(hier["field_evaluations"]["fine"] > 0 and hier["fine_passes_replayed"] > 0,
          f"trained_audit: the hierarchical step made no fine evaluation: {hier}")
    line = {"phase": "trained_audit", "steps": {"bfloat16_run": QUALITY_STEPS,
                                                "float32_run": AUDIT_F32_STEPS,
                                                "hierarchical": QUALITY_STEPS},
            "hierarchical": {**HIER_AUDIT, "perturb": HIER_AUDIT_PERTURB,
                             "field_evaluations": hier["field_evaluations"],
                             "seconds": time.monotonic() - t_hier},
            "worst": {k: audit_worst(a) for k, a in audits.items()}, "tol": TOL_AUDIT,
            "audits": audits, "seconds": time.monotonic() - t_phase}
    emit(line)
    bad = [f"{k}: {b}" for k, a in audits.items()
           for b in audit_failures(a, bf16_yardstick=k == "hierarchical")]
    check(not bad, f"trained_audit beyond its bars: {bad}")
    return line


def hier_audit_case(trainer, dev) -> tuple:
    """``trainer``'s pipeline with HIER_AUDIT's hierarchical pass, and params
    of it: the run's last checkpoint as the coarse field, warm-started into
    the fine one (``load_warm_start_params``), the fine field then moved by
    seeded normals of HIER_AUDIT_PERTURB times each tensor's std."""
    import copy
    import dataclasses

    import torch

    from satnerf_torch.configs import MainConfig
    from satnerf_torch.train.checkpoint import load_warm_start_params
    from satnerf_torch.train.state import init_params

    pipeline = copy.copy(trainer.pipeline)
    pipeline.cfg = MainConfig(trainer.cfg.run,
                              dataclasses.replace(trainer.cfg.pipeline, **HIER_AUDIT))
    scfg = pipeline.step_config(1, device=dev)
    params = init_params(torch.Generator().manual_seed(AUDIT_SEED), scfg.render.field,
                         pipeline.t_vocab, device=dev, use_fine_network=True)
    load_warm_start_params(params, os.path.join(trainer.cfg.run.run_dp, "ckpoints",
                                                "last.ckpt"))
    gen = torch.Generator().manual_seed(AUDIT_SEED)
    with torch.no_grad():
        for p in params["fine"].parameters():
            if p.numel() > 1:
                noise = torch.randn(p.shape, generator=gen).to(p.device)
                p.add_(noise * (HIER_AUDIT_PERTURB * float(p.float().std())))
    return pipeline, params


@contextlib_contextmanager
def tool_env(env: dict):
    """Within: ``env`` set and every other SATNERF_BENCH_* / SATNERF_RENDER_*
    variable unset; the environment as it was after."""
    saved = {k: v for k, v in os.environ.items() if k.startswith(("SATNERF_BENCH_",
                                                                   "SATNERF_RENDER_"))}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)
        os.environ.update(saved)


@contextlib_contextmanager
def k1_variants():
    """Within: K1's launches counted by head variant -> {"heads_on": n,
    "heads_off": n}."""
    from satnerf_torch.ops import field_fused as ff

    counts = {"heads_on": 0, "heads_off": 0}
    forward = ff._forward

    def counted(spec, *args, **kwargs):
        out = forward(spec, *args, **kwargs)
        counts["heads_on" if spec.heads_on else "heads_off"] += 1
        return out

    ff._forward = counted
    OPEN_COUNTS.append(counts)  # a replayed step counts here too (count_replays)
    try:
        yield counts
    finally:
        ff._forward = forward
        OPEN_COUNTS.remove(counts)


def counted_run(fn):
    """``fn()`` between reset and read launch counters -> (its result,
    launches, plain calls, K1 launches by head variant, seconds)."""
    t0 = time.monotonic()
    reset_counters()
    with k1_variants() as heads:
        out = fn()
    launches, plain = read_counters()
    return out, launches, plain, heads, time.monotonic() - t0


def bench_plain_check(dev, env: dict) -> dict:
    """The bench's configuration under ``env`` at its own batch (its
    synthetic rays and depth rays, seed-0 parameters) through the kernels
    and through their plain versions, held to TOL_AUDIT["bfloat16"]: one
    whole step on each side (``_audit_errors``), or for the hierarchical
    pass ``bench_replay_check`` on the recorded upstream gradients -> the
    worst error of each group, the rays, and the peak device GB of the
    kernels' step and of the plain one (or the replay). For the
    hierarchical pass, unbarred beside them: both engines against f64, and
    the replay under seeded upstream gradients, where a head's bias
    gradient is a sum that cancels and both bf16 engines stray from f64 by
    up to a tenth of it."""
    import torch

    from satnerf_torch import bench
    from satnerf_torch.train.state import create_train_state, init_params

    s = bench.settings(env)
    _, _, scfg = bench.configs(s, dev)
    params = init_params(torch.Generator().manual_seed(0), scfg.render.field, t_vocab=50,
                         device=dev, use_fine_network=s.hier > 0)
    batch = bench.synthetic_batch(s.batch, depth=bench.DEPTH_RAYS, device=dev)
    runs, peak_gb = {}, {}
    for plain in (False, True) if s.hier == 0 else (False,):
        state = create_train_state(copy_params(params, dev), 5e-4, steps_per_epoch=1000)
        torch.cuda.reset_peak_memory_stats()
        runs[plain] = recorded_step(scfg, state, batch, dev, plain)
        peak_gb["plain" if plain else "kernels"] = torch.cuda.max_memory_allocated() / 1e9
    if s.hier == 0:
        errs = _audit_errors(runs[False], runs[True])
    else:
        torch.cuda.reset_peak_memory_stats()
        replay = bench_replay_check(runs[False], params, dev)
        peak_gb["replay"] = torch.cuda.max_memory_allocated() / 1e9
        errs = replay["vs_plain"]
        seeded = bench_replay_check(runs[False], params, dev, upstream="seeded")
    bad = [f"{g} {k}: {e}" for g, bar in TOL_AUDIT["bfloat16"].items()
           for k, e in errs[g].items() if not e <= bar]
    check(not bad, f"bench {s.config_desc} against the plain versions: {bad}")
    out = {"worst": {g: max(v.values()) for g, v in errs.items() if v},
           "checked": {g: len(v) for g, v in errs.items()},
           "rays": [s.batch, bench.DEPTH_RAYS], "peak_gb": peak_gb,
           "mode": "step" if s.hier == 0 else "replay"}
    if s.hier:
        # unbarred: each engine's distance from the plain versions in f64, and
        # the replay under seeded upstream gradients, with its worst gradient
        def worst(r):
            return {g: max(v.values()) for g, v in r.items() if v}

        out.update({k: worst(replay[k]) for k in ("kernels_vs_float64", "plain_vs_float64")})
        name = max(seeded["vs_plain"]["grad"], key=seeded["vs_plain"]["grad"].get)
        out["seeded_upstream"] = {**{k: worst(v) for k, v in seeded.items()},
                                  "worst_grad": {k: {name: v["grad"][name]}
                                                 for k, v in seeded.items()}}
    return out


COMPOSITE_IO = (("sigmas", "albedo", "sun", "sky"),
                ("weights", "transparency", "depth", "rgb"))


def bench_replay_check(run: dict, params: dict, dev, upstream: str = "recorded") -> dict:
    """Each field evaluation of a recorded kernels' step (``recorded_step``)
    and each of its composites, replayed alone on its recorded inputs at the
    weights of the step (copies of ``params``), forward and backward: through
    the kernels (K1, K2, K4; K5 and its backward), through their plain
    versions, and through the plain versions in f64 (inputs and weights
    cast). The upstream gradients are the ones the step gave each output
    (``upstream="recorded"``: K2's and K5's backward inputs on the main
    path) or seeded normals (``"seeded"``). A field evaluation that the
    backward recomputes (remat) is replayed once. -> {"vs_plain": errors of
    the kernels against the plain versions (``rel_err``; "field" K1's
    outputs, "weights" K5's outputs, "grad" the field's parameter and
    embedding gradients (K2, K4) and K5's input gradients),
    "kernels_vs_float64", "plain_vs_float64": the same against f64}."""
    import torch

    from satnerf_torch.render import renderer

    weights = copy_params(params, dev)
    w64 = {k: v.double() for k, v in copy_params(params, dev).items() if k in ("field", "fine")}
    pairs = {"vs_plain": ("kernels", "plain"), "kernels_vs_float64": ("kernels", "float64"),
             "plain_vs_float64": ("plain", "float64")}
    errs = {name: {"loss": {}, "field": {}, "weights": {}, "grad": {}} for name in pairs}

    def compare(group, prefix, got):
        for name, (a, b) in pairs.items():
            errs[name][group].update({f"{prefix}.{k}": rel_err(v, got[b][k])
                                      for k, v in got[a].items()
                                      if got[b][k] is not None and got[b][k].numel()})

    def cast(a, f64):
        return None if a is None else (a.detach().double() if f64 else a.detach())

    def seeded(i, shapes):
        gen = torch.Generator(device=dev).manual_seed(AUDIT_SEED + i)
        return {k: torch.randn(shape, generator=gen, device=dev) for k, shape in shapes}

    seen = []
    for i, (args, _) in enumerate(run["field"]):
        if any(args[4] is a[4] for a in seen):
            continue
        seen.append(args)
        key = run["field_keys"][i]
        fcfg, dt, n_full = args[1:4]
        out, grads, g_out = {}, {}, None
        for engine in ("kernels", "plain", "float64"):
            f64 = engine == "float64"
            field = w64[key] if f64 else weights[key]
            emb = [None if a is None else cast(a, f64).clone().requires_grad_(True)
                   for a in args[7:9]]
            names = [n for n, _ in field.named_parameters()] + [
                n for n, e in zip(("t_emb", "t_s_emb"), emb) if e is not None]
            wrt = [p for _, p in field.named_parameters()] + [e for e in emb if e is not None]
            with plain_versions() if engine != "kernels" else contextlib_nullcontext():
                o = renderer._eval_field(field, fcfg, torch.float64 if f64 else dt, n_full,
                                         *(cast(a, f64) for a in args[4:7]), *emb)
                keys = [k for k, v in o.items() if v.requires_grad]
                if g_out is None:
                    rec = run["field_upstream"][i]
                    g_out = (seeded(i, [(k, o[k].shape) for k in keys]) if upstream == "seeded"
                             else {k: rec[k] if k in rec else torch.zeros_like(o[k])
                                   for k in keys})
                g = torch.autograd.grad([o[k] for k in keys], wrt,
                                        [g_out[k].to(o[k].dtype) for k in keys],
                                        allow_unused=True)
            out[engine] = {k: v.detach() for k, v in o.items()}
            grads[engine] = {f"{key}.{n}": v for n, v in zip(names, g)}
        compare("field", f"eval{i}", out)
        compare("grad", f"eval{i}", grads)
    for i, args in enumerate(run["composite"]):
        out, grads, g_out = {}, {}, None
        for engine in ("kernels", "plain", "float64"):
            f64 = engine == "float64"
            z_vals = cast(args[1], f64)
            ins = [cast(a, f64).clone().requires_grad_(True)
                   for j, a in enumerate(args) if j != 1]
            with plain_versions() if engine != "kernels" else contextlib_nullcontext():
                o = dict(zip(COMPOSITE_IO[1], renderer.composite(ins[0], z_vals, *ins[1:])))
                keys = [k for k, v in o.items() if v.requires_grad]
                if g_out is None:
                    rec = run["composite_upstream"][i]
                    g_out = (seeded(1000 + i, [(k, o[k].shape) for k in keys])
                             if upstream == "seeded" else
                             {k: rec[j] if j in rec else torch.zeros_like(o[k])
                              for j, k in enumerate(COMPOSITE_IO[1]) if k in keys})
                g = torch.autograd.grad([o[k] for k in keys], ins,
                                        [g_out[k].to(o[k].dtype) for k in keys])
            out[engine] = {k: v.detach() for k, v in o.items()}
            grads[engine] = dict(zip(COMPOSITE_IO[0], g))
        compare("weights", f"composite{i}", out)
        compare("grad", f"composite{i}", grads)
    torch.cuda.synchronize()
    return errs


def _check_bench_run(name: str, line: dict, launches: dict, plain: dict, heads: dict,
                     per_step: dict, steps: int) -> None:
    want = {k: v * steps for k, v in per_step.items()}
    check(launches == want, f"{name} launches {launches}, expected {want}")
    check(not any(plain.values()), f"{name}: a plain version ran: {plain}")
    check(heads["heads_off"] > 0 and 3 * heads["heads_off"] == launches["field_fused"],
          f"{name}: K1 by head variant {heads}")
    check(all(math.isfinite(line[k]) and line[k] > 0
              for k in ("value", "rays_per_sec_all_windows")), f"{name} value {line}")
    check(line["config"].split("/")[1] == "kernels", f"{name} config {line['config']}")


def bench_phase(dev) -> dict:
    """``satnerf_torch.bench.main()`` at the default configuration with
    BENCH_MAIN_STEPS steps a window, in this process (launch counters around
    it), one step of it against the plain versions, and ``python -m
    satnerf_torch.bench`` as a user runs it, in full."""
    import gc

    import torch

    from satnerf_torch import bench

    t_phase = time.monotonic()
    with tool_env({}):
        line, launches, plain, heads, secs = counted_run(lambda: bench.main(BENCH_MAIN_STEPS))
        steps = (1 + bench.WINDOWS) * BENCH_MAIN_STEPS
        _check_bench_run("bench", line, launches, plain, heads, PER_STEP, steps)
        check(line["config"] == "batch8192/kernels/chunks0/bf16/sc2",
              f"bench config {line['config']}")
        plain_err = bench_plain_check(dev, {})
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("SATNERF_BENCH_", "SATNERF_RENDER_"))}
        # the child needs the card: give back this process's cached blocks and
        # the pools of the graphs that are gone
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "-m", "satnerf_torch.bench"], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.monotonic() - t0
    check(proc.returncode == 0, f"python -m satnerf_torch.bench exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    check(cli["metric"] == "train_rays_per_sec_per_chip" and math.isfinite(cli["value"])
          and cli["value"] > 0 and cli["config"] == line["config"],
          f"bench CLI line {cli}")
    out = {"phase": "bench", "line": line, "steps_per_window": BENCH_MAIN_STEPS,
           "steps": steps, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "k1_by_heads": heads, "plain_calls": plain, "main_seconds": secs,
           "plain_check": plain_err, "plain_check_tol": TOL_AUDIT["bfloat16"], "cli_line": cli, "cli_seconds": cli_s,
           "seconds": time.monotonic() - t_phase}
    emit(out)
    return out


def bench_variants_phase(dev) -> dict:
    """Each of BENCH_VARIANTS through ``bench.main`` at BENCH_VARIANT_STEPS
    steps a window, with the checks of ``bench_phase``."""
    from satnerf_torch import bench

    t_phase = time.monotonic()
    out = {"phase": "bench_variants", "steps_per_window": BENCH_VARIANT_STEPS, "runs": {}}
    steps = (1 + bench.WINDOWS) * BENCH_VARIANT_STEPS
    for name, (env, per_step) in BENCH_VARIANTS.items():
        with tool_env(env):
            line, launches, plain, heads, secs = counted_run(
                lambda: bench.main(BENCH_VARIANT_STEPS))
        _check_bench_run(f"bench {name}", line, launches, plain, heads, per_step, steps)
        out["runs"][name] = {"line": line, "launches": launches, "k1_by_heads": heads,
                             "seconds": secs, "plain_check": bench_plain_check(dev, env)}
    out["launches"] = {name: r["launches"] for name, r in out["runs"].items()}
    out["seconds"] = time.monotonic() - t_phase
    emit(out)
    return out


def tools_phase(dev) -> dict:
    """render_bench, speed_of_light and feed_rate through their ``main``s:
    each line finite and positive, the kernels launched as their renders and
    steps call them, no plain version."""
    from satnerf_torch.tools import feed_rate, render_bench, speed_of_light

    t_phase = time.monotonic()
    out = {}
    with tool_env({}):
        line, launches, plain, heads, secs = counted_run(render_bench.main)
    chunks = (1 + render_bench.WINDOWS) * render_bench.settings({}).scan
    want = dict.fromkeys(launches, 0)
    want.update(field_fused=chunks, composite=chunks)
    check(launches == want and heads["heads_off"] == 0,
          f"render_bench launches {launches} {heads}, expected {want}")
    check(not any(plain.values()), f"render_bench: a plain version ran: {plain}")
    check(math.isfinite(line["value"]) and line["value"] > 0, f"render_bench {line}")
    out["render_bench"] = {"line": line, "launches": launches, "seconds": secs}

    with tool_env({}):
        sol, launches, plain, heads, secs = counted_run(lambda: speed_of_light.main(SOL_ARGS))
    n = (1 + speed_of_light.TRIALS) * int(SOL_ARGS[SOL_ARGS.index("--scan") + 1])
    # fwd: a render of the main (heads on) and solar-correction (heads off)
    # halves, K5 on the main half; step: PER_STEP
    want = {k: v * n for k, v in PER_STEP.items()}
    want["field_fused"] += 2 * n
    want["composite"] += n
    check(launches == want, f"speed_of_light launches {launches}, expected {want}")
    check(not any(plain.values()), f"speed_of_light: a plain version ran: {plain}")
    check(all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in sol["rows"])
          and all(0 < r["mfu_vs_peak"] < 1 for r in sol["rows"] if "mfu_vs_peak" in r),
          f"speed_of_light rows {sol['rows']}")
    out["speed_of_light"] = {"line": sol, "args": SOL_ARGS, "launches": launches,
                             "k1_by_heads": heads, "seconds": secs}

    # an empty argv: feed_rate's parser would read this script's own flags
    feed, launches, plain, _, secs = counted_run(lambda: feed_rate.main([]))
    check(not any(launches.values()) and not any(plain.values()),
          f"feed_rate ran a kernel: {launches} {plain}")
    check(math.isfinite(feed["rays_per_s"]) and feed["rays_per_s"] > 0, f"feed_rate {feed}")
    out["feed_rate"] = {"line": feed, "launches": launches, "seconds": secs}
    line = {"phase": "tools", **out, "seconds": time.monotonic() - t_phase}
    emit(line)
    return line


def _width_inputs(fcfg, n: int, seed: int, dev, out_w: int = 16) -> tuple:
    """(encoded points, sun directions, t embeddings, a gradient of the
    ``out_w`` raw columns, a gradient of the trunk output) for ``n`` points,
    seeded."""
    import torch

    from satnerf_torch.core.encoding import positional_encoding

    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n, 3, generator=g) * 2 - 1
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    te = torch.randn(n, fcfg.t_embedding_tau, generator=g)
    g_out = torch.randn(n, out_w, generator=g)
    cot = torch.randn(n, fcfg.feat, generator=g)
    return tuple(t.to(dev) for t in (positional_encoding(xyz, fcfg.mapping_pos_n_freq), sun,
                                     te, g_out, cot))


def _bwd_check(what: str, got: dict, ref: dict, dname: str, plain_f32, notes: list) -> float:
    """The largest rel_err of the kernel outputs ``got`` against the plain
    version's ``ref``, each checked against TOL_FIELD_BWD; in bf16 a tensor
    beyond that bar passes where the kernel lies no farther from the plain
    version in f32 on the same inputs (``plain_f32()``) than the plain bf16
    version does, plus the bar (``audit_failures``' rule: in a tensor that
    cancels, one-ulp flips of bf16 activations on either side reach past the
    bar), and is written to ``notes``."""
    bar, worst, r32 = TOL_FIELD_BWD[dname], 0.0, None
    for k in ref:
        e = rel_err(got[k], ref[k])
        worst = max(worst, e)
        if e <= bar:
            continue
        check(dname == "bfloat16", f"{what} {k} err {e}")
        r32 = r32 or plain_f32()
        d_k, d_p = rel_err(got[k], r32[k]), rel_err(ref[k], r32[k])
        notes.append({"check": f"{what} {k}", "vs_plain": e, "kernel_vs_f32": d_k,
                      "plain_vs_f32": d_p})
        check(d_k <= d_p + bar, f"{what} {k}: {e} from the plain version; from f32 "
                                f"{d_k} against the plain bf16 version's {d_p}")
    return worst


def _fwd_check(what: str, got, ref, dname: str, bar: float, metric, ref64, notes: list) -> float:
    """``metric`` (abs_err or rel_err) of a forward output ``got`` against its
    plain version's ``ref``, checked against ``bar``; given ``ref64`` (trunks
    past 512 wide), a bf16 output beyond it passes where the kernel lies no
    farther from the plain version in f64 on the same inputs (``ref64()``)
    than the plain bf16 version does, plus the bar (_bwd_check's rule: at K
    past 512 a one-ulp flip of a bf16 activation, carried through the
    layers, reaches past the bar), and is written to ``notes``."""
    e = metric(got, ref)
    if e <= bar:
        return e
    check(dname == "bfloat16" and ref64 is not None, f"{what} err {e}")
    r64 = ref64()
    d_k, d_p = metric(got, r64), metric(ref, r64)
    notes.append({"check": what, "vs_plain": e, "kernel_vs_f64": d_k, "plain_vs_f64": d_p})
    check(d_k <= d_p + bar, f"{what}: {e} from the plain version; from f64 {d_k} against "
                            f"the plain bf16 version's {d_p}")
    return e


def _relu_agree_rows(what: str, spec, shared, aux, g_out, packed, notes: list):
    """The rows on which K2 and its plain version recompute the sky head's
    pre-activation (the one ReLU of the heads) with the same sign in every
    column; None when that is every row. The ReLU's derivative is undefined
    at 0, so where the two recomputations fall on two sides of it the two
    gradients differ by a whole term: each such entry must lie within
    TOL_KINK of 0, relative to the largest pre-activation, and is written to
    ``notes``."""
    from satnerf_torch.ops import field_fused as ff

    if not spec.heads_on:
        return None
    tk, tr = {}, {}
    ff.heads_backward(spec, shared, aux, g_out, packed, trace=tk)
    ff.heads_backward_reference(spec, shared, aux, g_out, packed, trace=tr)
    ak, ar = tk["pre"]["sky0"].float(), tr["pre"]["sky0"].float()
    flip = (ak > 0) != (ar > 0)
    if not bool(flip.any()):
        return None
    near = float(ar[flip].abs().max()) / float(ar.abs().max())
    notes.append({"check": f"{what} sky ReLU", "entries": int(flip.sum()),
                  "rows": int(flip.any(1).sum()), "of_rows": int(flip.shape[0]),
                  "largest_abs_pre_activation_rel": near})
    check(near <= TOL_KINK, f"{what}: the sky pre-activations differ in sign at {near} "
                            f"of their largest, beyond {TOL_KINK}")
    return ~flip.any(1)


def width_kernel_checks(key: str, spec, fused: bool, packed, inputs, dname: str,
                        n: int, notes: list, k4: bool = True) -> dict:
    """On the first ``n`` of ``inputs``: K1 (both head variants) with K2 and
    K4 (both engines) on K1's residuals, or K3 (with and without the
    pre-activations) with K4 (both engines; not with ``k4`` False), each
    against its plain version within today's bars (_fwd_check, the bf16
    yardstick on the forward outputs past 512 wide only; _bwd_check,
    _relu_agree_rows) and run twice, bitwise equal. -> {check: error}."""
    import dataclasses

    import torch

    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    enc, sun, te, g_out, cot = (t[:n] for t in inputs[:5])
    ts = inputs[5][:n] if len(inputs) > 5 else None  # the separate semantic t-embedding
    dt = packed["w0"].dtype
    x = ff.pack_x(spec, enc, dt)
    p32 = {k: v.float() for k, v in packed.items()}  # the same weights, for f32 yardsticks
    p64 = {k: v.double() for k, v in packed.items()}  # and for f64 ones
    errs = {}

    def fwd(what, got, ref, bar, metric, ref64):
        return _fwd_check(what, got, ref, dname, bar, metric,
                          ref64 if spec.feat > trunk.SMEM_MAX_FEAT else None, notes)

    def same(a: list, b: list) -> bool:
        return all((u is None and v is None) or torch.equal(u, v) for u, v in zip(a, b))

    def f32(t):
        return None if t is None else t.float()

    if not fused:
        for emit in (False, True):
            runs = [trunk._forward(spec, x, packed, emit) for _ in range(2)]
            torch.cuda.synchronize()
            tag = f"{key} K3 acts={emit}"
            check(same(*runs), f"{tag}: two runs differ")
            out, acts = runs[0]
            ref, ref_acts = trunk.fused_trunk_reference(spec, x, packed, emit)

            def k3_f64(i, emit=emit):
                return trunk.fused_trunk_reference(spec, x.double(), p64, emit)[i]

            errs[f"k3/acts_{emit}"] = fwd(f"{key} n{n} {dname} K3 acts={emit}", out, ref,
                                          TOL_FIELD[dname], abs_err, lambda: k3_f64(0))
            if emit:
                errs["k3/pre_activations_rel"] = fwd(
                    f"{key} n{n} {dname} K3 pre-activations", acts, ref_acts,
                    TOL_RESID[dname], rel_err, lambda: k3_f64(1))
        if not k4:
            return errs
        g = cot.to(dt)
        for bwd in ("recompute", "stored"):
            sb = dataclasses.replace(spec, trunk_bwd=bwd)
            acts = trunk._forward(sb, x, packed, True)[1] if bwd == "stored" else None
            runs = [list(trunk.trunk_backward(sb, x, packed, acts, g)) for _ in range(2)]
            torch.cuda.synchronize()
            check(same(*runs), f"{key} K4 {bwd}: two runs differ")
            ref = trunk.trunk_backward_reference(sb, x, packed, acts, g)
            errs[f"k4/{bwd}"] = _bwd_check(
                f"{key} n{n} {dname} K4 {bwd}", dict(zip(TRUNK_GRADS, runs[0])),
                dict(zip(TRUNK_GRADS, ref)), dname,
                lambda: dict(zip(TRUNK_GRADS, trunk.trunk_backward_reference(
                    sb, x.float(), p32, f32(acts), g.float()))), notes)
        return errs

    aux = ff.pack_aux(spec, sun, te, ts, dt)
    for heads_on in (True, False):
        sp = dataclasses.replace(spec, heads_on=heads_on)
        tag = "heads_on" if heads_on else "heads_off"
        runs = [ff.fused_field(sp, x, aux, packed) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(*runs), f"{key} K1 {tag}: two runs differ")
        errs[f"k1/{tag}"] = fwd(
            f"{key} n{n} {dname} K1 {tag}", runs[0], ff.fused_field_reference(sp, x, aux, packed),
            TOL_FIELD[dname], abs_err,
            lambda sp=sp: ff.fused_field_reference(sp, x.double(), aux.double(), p64))
        for bwd in ("recompute", "stored"):
            sb = dataclasses.replace(sp, trunk_bwd=bwd)
            what = f"{key} n{n} {dname} {tag} {bwd}"
            _, shared, acts = ff._forward(sb, x, aux, packed, resid=True)
            runs = []
            for _ in range(2):
                h = ff.heads_backward(sb, shared, aux, g_out, packed)
                t = trunk.trunk_backward(sb, x, packed, acts, h[0])
                runs.append({"g_shared": h[0], "g_aux": h[1], **h[2],
                             **dict(zip(TRUNK_GRADS, t))})
            torch.cuda.synchronize()
            check(all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]),
                  f"{what}: K2/K4 two runs differ")
            _, rs, ra = ff._reference_forward(sb, x, aux, packed, True)
            rh = ff.heads_backward_reference(sb, shared, aux, g_out, packed)
            rt = trunk.trunk_backward_reference(sb, x, packed, acts, rh[0])

            def k1_f64(i, sb=sb):
                return ff._reference_forward(sb, x.double(), aux.double(), p64, True)[i]

            resid = [fwd(f"{what} K1 residual shared", shared, rs, TOL_RESID[dname], rel_err,
                         lambda: k1_f64(1))]
            if acts is not None:
                resid.append(fwd(f"{what} K1 residual pre-activations", acts, ra,
                                 TOL_RESID[dname], rel_err, lambda: k1_f64(2)))
            errs[f"k1_residuals/{tag}/{bwd}"] = max(resid)

            def k4_f32():
                r = ff.heads_backward_reference(sb, shared.float(), aux.float(), g_out, p32)
                return dict(zip(TRUNK_GRADS, trunk.trunk_backward_reference(
                    sb, x.float(), p32, f32(acts), r[0])))

            errs[f"k4/{tag}/{bwd}"] = _bwd_check(
                f"{what} K4", {k: runs[0][k] for k in TRUNK_GRADS},
                dict(zip(TRUNK_GRADS, rt)), dname, k4_f32, notes)
            # K2 on the rows where both recompute the sky ReLU's decisions alike
            # (the sky head feeds no trunk gradient, so K4 above took every row)
            rows = _relu_agree_rows(f"{what} K2", sb, shared, aux, g_out, packed, notes)
            on = (shared, aux, g_out) if rows is None else (shared[rows], aux[rows], g_out[rows])
            if rows is None:
                got2 = {k: v for k, v in runs[0].items() if k not in TRUNK_GRADS}
            else:
                h = ff.heads_backward(sb, *on, packed)
                got2 = {"g_shared": h[0], "g_aux": h[1], **h[2]}
                rh = ff.heads_backward_reference(sb, *on, packed)
            ref2 = {"g_shared": rh[0], "g_aux": rh[1], **rh[2]}

            def k2_f32():
                r = ff.heads_backward_reference(sb, on[0].float(), on[1].float(), on[2], p32)
                return {"g_shared": r[0], "g_aux": r[1], **r[2]}

            errs[f"k2/{tag}/{bwd}"] = _bwd_check(f"{what} K2", got2, ref2, dname, k2_f32,
                                                 notes)
    return errs


def width_times(spec, fused: bool, packed, inputs, dname: str, only=None) -> dict:
    """Device ms (``device_time``) at the largest of WIDTH_POINTS of the route's
    kernels (those named in ``only``, if given): K1 with residuals, K2 and K4
    ("recompute"); or K3 and K4; each beside its bound (``FieldSpec``'s
    multiply-adds over the guide's peaks, or its bytes, whichever is larger)
    and the launches the timing made."""
    import torch

    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    n = max(WIDTH_POINTS)
    enc, sun, te, g_out, cot = inputs[:5]
    ts = inputs[5][:n] if len(inputs) > 5 else None
    dt = packed["w0"].dtype
    esz = 2 if dt == torch.bfloat16 else 4
    x = ff.pack_x(spec, enc[:n], dt)
    F, L = spec.feat, spec.layers
    trunk_macs = spec.c_in * F + (L - 1) * F * F + len(spec.skips) * spec.c_in * F
    rows = {}

    def row(name, fn, macs, nbytes, reps):
        if only is not None and name not in only:
            return
        before = read_counters()[0]
        t = device_time(fn, reps=reps, warmup=2, repeats=3)
        after = read_counters()[0]
        bounds = op_bounds(2.0 * macs * n, dname)
        ops_ms = bounds.pop("ops_ms")
        bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
        rows[name] = {"ms": t["ms"], "host_issue_us": t["host_issue_us"], **bounds,
                      "bound_ms": max(ops_ms, bytes_ms),
                      "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                      "points": n, "timed_launches": {k: after[k] - before[k] for k in after
                                                      if after[k] != before[k]}}

    if fused:
        aux = ff.pack_aux(spec, sun[:n], te[:n], ts, dt)
        _, shared, _ = ff._forward(spec, x, aux, packed, resid=True)
        g_shared = ff.heads_backward(spec, shared, aux, g_out[:n], packed)[0]
        ow = spec.out_w
        row("field_fused", lambda: ff._forward(spec, x, aux, packed, True),
            spec.mac_per_point(), n * ((spec.cx + spec.aux_w + F) * esz + ow * 4), 10)
        row("heads_bwd", lambda: ff.heads_backward(spec, shared, aux, g_out[:n], packed),
            spec.heads_bwd_mac_per_point(), n * ((2 * F + 2 * spec.aux_w) * esz + ow * 4), 5)
        row("trunk_bwd", lambda: trunk.trunk_backward(spec, x, packed, None, g_shared,
                                                       need_gx=False),
            spec.trunk_bwd_mac_per_point(), n * (spec.cx + F) * esz, 5)
    else:
        g = cot[:n].to(dt)
        row("trunk_fwd", lambda: trunk._forward(spec, x, packed, False), trunk_macs,
            n * (spec.cx + F) * esz, 10)
        row("trunk_bwd", lambda: trunk.trunk_backward(spec, x, packed, None, g, need_gx=False),
            spec.trunk_bwd_mac_per_point(), n * (spec.cx + F) * esz, 5)
    return rows


def widths_cli_run(dev, work: str) -> dict:
    """The four-scene workflow's training at its defaults through the
    training CLI (``start_training`` on the TOMLs that
    satnerf_torch/tools/four_scenes.py writes: 8 x 256, 32 samples, 2,048
    rays, bf16, depth on, steps_per_dispatch 8) on one of its scenes at
    WIDTHS_SCENE, WIDTHS_CLI_STEPS steps: K1 (with 128-wide heads), K2, K4, K5
    and K5's backward launched by the step schedule, no plain version,
    finite loss terms."""
    import math

    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.models.field import use_fused_field
    from satnerf_torch.run.training import start_training
    from satnerf_torch.tools import four_scenes

    name = "SYN_SUBURB"
    generate_scene(os.path.join(work, "datasets", name), aoi_name=name, **WIDTHS_SCENE,
                   **four_scenes.SCENES[name])
    run_fp, pipe_fp = os.path.join(work, "run.toml"), os.path.join(work, "rs_semantic.toml")
    with open(run_fp, "w") as f:
        f.write(four_scenes.RUN_TOML.format(root=work, steps=WIDTHS_CLI_STEPS)
                .replace('"PLACEHOLDER"', f'"{name}"'))
    with open(pipe_fp, "w") as f:  # the tool's defaults: --batch 2048 --units 256 --n-samples 32
        f.write(four_scenes.PIPE_TOML.format(batch=2048, units=256, n_samples=32))
    reset_counters()
    t0 = time.monotonic()
    try:
        pipeline, state, trainer = start_training(run_fp, pipe_fp, device=dev, log_every=1)
    finally:
        disable_tf32()  # the run's matmul_precision "high" allowed TF32
    seconds = time.monotonic() - t0
    got, plain = read_counters()
    cfg = state.params["field"].cfg
    check((cfg.layers, cfg.feat, cfg.feat_last) == (8, 256, 128) and use_fused_field(cfg),
          f"widths CLI field {cfg.layers}x{cfg.feat}, heads {cfg.feat_last}")
    check(state.step == WIDTHS_CLI_STEPS and trainer.cfg.run.steps_per_dispatch == 8,
          f"widths CLI ended at step {state.step}")
    want = scene_expected_launches(trainer, WIDTHS_CLI_STEPS, pipeline.ds_drop_step)
    check(got == want, f"widths CLI launches {got}, expected {want}")
    check(not any(plain.values()), f"widths CLI: a plain version ran: {plain}")
    hist = trainer.history
    check(len(hist) == WIDTHS_CLI_STEPS
          and all(math.isfinite(v) for h in hist for v in h.values()),
          "widths CLI: missing or non-finite loss terms")
    return {"steps": WIDTHS_CLI_STEPS, "rays": 2048, "n_samples": 32, "field": "8x256",
            "feat_last": 128, "dtype": "bfloat16", "steps_per_dispatch": 8,
            "depth_drop_step": pipeline.ds_drop_step, "seconds": seconds,
            "loop_ms_per_step": trainer.ms_per_step, "launches": got, "plain_calls": plain,
            "metrics_last": hist[-1]}


def widths_phase(dev, vocab: int, turns: list | None, build_s: dict) -> dict:
    """Every trunk width the JAX kernels take below 512 (WIDTH_PAIRS) at the
    rs_semantic TOML's depth: each route's kernels against their plain
    versions at WIDTH_POINTS in f32 and bf16 (width_kernel_checks), their
    device times (width_times), the four-scene workflow's 8 x 256 training
    through the CLI (widths_cli_run) and the examples' 2 x 128 field in the
    flagship step config (train_phase: K3, K4 and K5 on every step, a 32-ray
    step against the CPU). With ``turns``, the parent's build seconds and
    K1-K4's outputs at 512 against the parent build's (parent_outputs_check)."""
    import shutil
    import tempfile

    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models.field import (Field, fused_field_spec, use_fused_field,
                                            use_fused_trunk)

    t_phase = time.monotonic()
    pairs, notes = {}, []
    for feat, fl in WIDTH_PAIRS:
        key = f"{feat}x{fl}"
        rcfg = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas",
                                  fc_units=feat, fc_use_full_features=fl == feat)
        fcfg = rcfg.field
        fused = use_fused_field(fcfg)
        check(fcfg.feat_last == fl and (fused or use_fused_trunk(fcfg)), f"{key} route")
        field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
        spec = fused_field_spec(fcfg)
        inputs = _width_inputs(fcfg, max(WIDTH_POINTS), feat + fl, dev)
        entry = {"route": "K1, K2, K4" if fused else "K3, K4, heads layer by layer",
                 "layers": spec.layers, "skips": list(spec.skips), "errors": {}, "times": {}}
        before = read_counters()[0]
        with torch.no_grad():
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                packed = field.packed(dt)
                worst = entry["errors"][dname] = {}  # each check's largest over WIDTH_POINTS
                for n in WIDTH_POINTS:
                    for k, e in width_kernel_checks(key, spec, fused, packed, inputs, dname,
                                                    n, notes).items():
                        worst[k] = max(worst.get(k, 0.0), e)
                entry["times"][dname] = width_times(spec, fused, packed, inputs, dname)
        after = read_counters()[0]
        entry["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        pairs[key] = entry
        del field, inputs
        torch.cuda.empty_cache()
    checks_s = time.monotonic() - t_phase

    work = tempfile.mkdtemp(prefix="widths_")
    try:
        cli = widths_cli_run(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    examples = train_phase(dev, vocab, "widths_examples_step", EXAMPLES_FIELD, PER_STEP_BETA_S,
                           stored_check=False)

    parent = None
    if turns:
        bitwise = parent_outputs_check("at 512")
        mine, theirs = turn_means(turns)
        parent = {"outputs_vs_parent_512": bitwise,
                  "build_seconds": {k: v for k, v in (turns[0].get("build") or {}).items()
                                    if k != "forward_kernels"},
                  "this_ms_512": {k: v for k, v in mine.items()
                                  if k.split("/")[0] in PARENT_KERNEL_KEYS},
                  "parent_ms_512": {k: v for k, v in theirs.items()
                                    if k.split("/")[0] in PARENT_KERNEL_KEYS}}
    line = {"phase": "widths", "pairs": pairs, "points": WIDTH_POINTS, "notes": notes,
            "cli": cli, "examples_step": {"launches": examples["launches"],
                                          "field": EXAMPLES_FIELD},
            "build_seconds": build_s, "parent": parent,
            "checks_seconds": checks_s, "seconds": time.monotonic() - t_phase,
            "tol": {"forward": TOL_FIELD, "backward": TOL_FIELD_BWD, "residuals": TOL_RESID,
                    "relu_kink": TOL_KINK}}
    emit(line)
    # per kernel and width: device ms and bound in each dtype, the launches of
    # the checks and timings, and those of the main paths at their widths
    paths = {"256x128": ("cli_8x256_launches", cli["launches"]),
             "128x64": ("examples_step_2x128_launches", examples["launches"])}
    by_kernel = {}
    for key, entry in pairs.items():
        for dname, rows in entry["times"].items():
            for name, r in rows.items():
                cell = by_kernel.setdefault(name, {}).setdefault(
                    key, {"check_launches": entry["launches"].get(name, 0)})
                if key in paths:
                    cell[paths[key][0]] = paths[key][1][name]
                cell[dname] = {k: r[k] for k in ("ms", "bound_ms", "bound_by")}
    line["by_kernel"] = by_kernel
    return line


def parent_outputs_bitwise() -> dict:
    """{kernel/dtype: whether this tree's K1-K4 outputs at the flagship (512
    wide, c_in 60) equal the parent build's bit for bit}: port_times' saved
    outputs of the first two turns (parent, this)."""
    import torch

    a, b = (torch.load(os.path.join(REPO, "build", "turns", f"turn{i}.pt")) for i in (0, 1))
    return {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a}


# Outputs whose arithmetic the warp-specialised reduction changed by design:
# in bf16 it sums the bias gradients (sum jobs) in chunks of kSplitRows rows
# added in order, where the earlier reduction walked all rows in one block
# per 64 columns. They are held against the parent build's at the backward
# kernels' bar; every other output stays bitwise the parent build's.
PARENT_BARS = {"k2/bfloat16": TOL_FIELD_BWD["bfloat16"],
               "k4_recompute/bfloat16": TOL_FIELD_BWD["bfloat16"],
               "k4_stored/bfloat16": TOL_FIELD_BWD["bfloat16"]}


def parent_outputs_check(where: str) -> dict:
    """parent_outputs_bitwise, checked: each output bitwise the parent
    build's, or for the PARENT_BARS keys within their bar (each tensor's
    rel_err against the parent's); -> {"bitwise", "rel_err" of those that
    differ}."""
    import torch

    bitwise = parent_outputs_bitwise()
    a, b = (torch.load(os.path.join(REPO, "build", "turns", f"turn{i}.pt")) for i in (0, 1))
    errs = {k: max(rel_err(y, x) for x, y in zip(a[k], b[k])) for k, same in bitwise.items()
            if not same}
    check(all(k in PARENT_BARS and e <= PARENT_BARS[k] for k, e in errs.items()),
          f"K1-K4 {where} differ from the parent build's: {bitwise}, {errs}")
    return {"bitwise": bitwise, "rel_err": errs}


def k1_input_checks(key: str, spec, packed, inputs, dname: str) -> dict:
    """K1 (both head variants, with the "stored" residuals) on ``inputs``
    against its plain version: outputs within TOL_FIELD, residuals within
    TOL_RESID, two runs bitwise equal. -> {check: error}."""
    import dataclasses

    import torch

    from satnerf_torch.ops import field_fused as ff

    enc, sun, te = inputs[:3]
    dt = packed["w0"].dtype
    x, errs = ff.pack_x(spec, enc, dt), {}
    for heads_on in (True, False):
        sp = dataclasses.replace(spec, heads_on=heads_on, trunk_bwd="stored")
        tag = "heads_on" if heads_on else "heads_off"
        aux = ff.pack_aux(sp, sun, te, None, dt)
        runs = [ff._forward(sp, x, aux, packed, resid=True) for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(*runs)), f"{key} K1 {tag}: two runs differ")
        out, shared, acts = runs[0]
        ref, ref_shared, ref_acts = ff._reference_forward(sp, x, aux, packed, True)
        errs[f"k1/{tag}"] = float((out - ref).abs().max())
        check(errs[f"k1/{tag}"] <= TOL_FIELD[dname], f"{key} K1 {tag} err {errs}")
        errs[f"k1_residuals/{tag}"] = max(rel_err(shared, ref_shared), rel_err(acts, ref_acts))
        check(errs[f"k1_residuals/{tag}"] <= TOL_RESID[dname], f"{key} K1 residuals {errs}")
    return errs


def input_widths_phase(dev, vocab: int, turns: list | None) -> dict:
    """Encoded inputs past 64 wide (INPUT_FREQS: c_in 66, 72, 96, 126) at
    the trunk widths up to 512 (INPUT_FEAT_WIDTHS) in f32 and bf16, INPUT_POINTS points:
    K1 (k1_input_checks), K3 (with and without the pre-activations) and K4
    (both engines, gx included; width_kernel_checks) against their plain
    versions within today's bars; K1's, K3's and K4's device ms beside their
    bounds at 512 wide and INPUT_TIME_FREQS; then the rs_semantic TOML at
    POSENC_FREQ frequencies: five flagship training steps (train_phase: K1,
    K2, K4, K5 and its backward every step, no plain version, a 32-ray step
    against the CPU) and one 128 x 128 request (serve_variant_phase). With
    ``turns``, K1-K4's outputs at c_in 60 against the parent build's
    (parent_outputs_check)."""
    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models.field import Field, fused_field_spec, use_fused_field
    from satnerf_torch.ops import _bwd, trunk
    from satnerf_torch.ops.field_fused import KERNEL_WIDTHS

    t_phase = time.monotonic()
    cells, notes, times = {}, [], {}
    before = read_counters()[0]
    cases = [(f, w) for f in INPUT_FREQS for w in INPUT_FEAT_WIDTHS]
    cases += [(f, 512) for f in INPUT_TIME_FREQS if f not in INPUT_FREQS]
    for n_freq, feat in cases:
        fl = feat // 2 if (feat, feat // 2) in KERNEL_WIDTHS else feat
        key = f"c{6 * n_freq}/{feat}x{fl}"
        rcfg = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas", fc_units=feat,
                                  fc_use_full_features=fl == feat, mapping_pos_n_freq=n_freq)
        fcfg = rcfg.field
        spec = fused_field_spec(fcfg)
        check(use_fused_field(fcfg) and fcfg.feat_last == fl and spec.c_in == 6 * n_freq
              and _bwd.padded_k(spec.cx) <= trunk.TC_MAX_K, f"{key} route")
        field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
        inputs = _width_inputs(fcfg, INPUT_POINTS, n_freq + feat, dev)
        with torch.no_grad():
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                packed = field.packed(dt)
                if n_freq in INPUT_FREQS:
                    cells.setdefault(key, {})[dname] = {
                        **k1_input_checks(key, spec, packed, inputs, dname),
                        **width_kernel_checks(key, spec, False, packed, inputs, dname,
                                              INPUT_POINTS, notes)}
                if feat == 512 and n_freq in INPUT_TIME_FREQS:
                    times.setdefault(f"c{6 * n_freq}", {})[dname] = {
                        **width_times(spec, True, packed, inputs, dname,
                                      only=("field_fused", "trunk_bwd")),
                        **width_times(spec, False, packed, inputs, dname, only=("trunk_fwd",))}
        del field, inputs
        torch.cuda.empty_cache()
    after = read_counters()[0]
    check_launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    checks_s = time.monotonic() - t_phase

    step = train_phase(dev, vocab, f"train_posenc{POSENC_FREQ}",
                       {"mapping_pos_n_freq": POSENC_FREQ}, PER_STEP, stored_check=False)
    fcfg = step["scfg"].render.field
    check(fcfg.xyz_in == 6 * POSENC_FREQ and use_fused_field(fcfg),
          f"posenc step field c_in {fcfg.xyz_in}")
    serve = serve_variant_phase(f"serve_posenc{POSENC_FREQ}", dev, step["scfg"].render,
                                step["params"], vocab,
                                {"field_fused": 1, "trunk_fwd": 0, "composite": 1,
                                 "trunk_fwd_interleaved": 0})
    parent = None
    if turns:
        bitwise = parent_outputs_check("at c_in 60")
        mine, theirs = turn_means(turns)
        parent = {"outputs_vs_parent_c_in_60": bitwise,
                  "forward_kernels": {t["tree"]: t["build"].get("forward_kernels")
                                      for t in turns[:2]},
                  "this_ms_c_in_60": {k: v for k, v in mine.items()
                                      if k.split("/")[0] in PARENT_KERNEL_KEYS},
                  "parent_ms_c_in_60": {k: v for k, v in theirs.items()
                                        if k.split("/")[0] in PARENT_KERNEL_KEYS}}
    line = {"phase": "input_widths", "freqs": INPUT_FREQS,
            "c_in": [6 * f for f in INPUT_FREQS], "feat": INPUT_FEAT_WIDTHS,
            "points": INPUT_POINTS, "errors": cells, "notes": notes, "times_512": times,
            "check_launches": check_launches,
            "posenc_step": {"launches": step["launches"], "n_freq": POSENC_FREQ},
            "posenc_serve": serve, "parent": parent, "checks_seconds": checks_s,
            "seconds": time.monotonic() - t_phase,
            "tol": {"forward": TOL_FIELD, "backward": TOL_FIELD_BWD, "residuals": TOL_RESID}}
    emit(line)
    return line


def head_widths_cli_run(dev, work: str) -> dict:
    """The training CLI (``start_training``) on a generated scene whose root
    file lists HEAD_CLASSES class names (the labels drawn stay those the
    generator draws), on the rs_semantic TOML with t_embedding_tau 16,
    HEAD_CLI_STEPS steps: K1 (a 32-column output, a 48-column aux tile), K2,
    K4, K5 and K5's backward launched by the step schedule, no plain
    version, finite loss terms."""
    import math

    from satnerf_torch.configs import write_toml
    from satnerf_torch.datasets.synthetic import generate_scene
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.io.json_io import read_json, write_json
    from satnerf_torch.models.field import fused_field_spec, use_fused_field
    from satnerf_torch.run.training import start_training

    scene_dp = os.path.join(work, "datasets", "SYN")
    generate_scene(scene_dp, **HEAD_SCENE)
    root_fp = os.path.join(scene_dp, "root.json")
    root = read_json(root_fp)
    labels = dict(root["semantic_cls_labels"])
    for i in range(len(labels), HEAD_CLASSES):
        labels[str(i)] = f"class_{i}"
    root["semantic_cls_labels"] = labels
    write_json(root_fp, root)
    run_fp, pipe_fp = os.path.join(work, "run.toml"), os.path.join(work, "pipeline.toml")
    write_toml(run_fp, {
        "max_train_steps": HEAD_CLI_STEPS, "save_every_n_epochs": -1,
        "check_val_every_n_epoch": 1, "num_sanity_val_steps": 0, "seed": 0,
        "dataset_name": "SYN", "datasets_dp": os.path.join(work, "datasets"),
        "cache_dp": os.path.join(work, "cache"), "workspace_dp": os.path.join(work, "training")})
    with open(PIPELINE_TOML) as f:
        body = [ln for ln in f.read().splitlines() if ln.split("=")[0].strip() not in HEAD_STEP]
    with open(pipe_fp, "w") as f:
        f.write("\n".join(body + [f"{k} = {v}" for k, v in HEAD_STEP.items()]) + "\n")
    reset_counters()
    t0 = time.monotonic()
    try:
        pipeline, state, trainer = start_training(run_fp, pipe_fp, device=dev, log_every=1)
    finally:
        disable_tf32()  # the run's matmul_precision "high" allowed TF32
    seconds = time.monotonic() - t0
    got, plain = read_counters()
    cfg = state.params["field"].cfg
    spec = fused_field_spec(cfg)
    check(cfg.t_embedding_tau == 16 and cfg.n_classes == HEAD_CLASSES and use_fused_field(cfg)
          and (spec.out_w, spec.aux_pad) == (32, 48),
          f"head widths CLI field: tau {cfg.t_embedding_tau}, {cfg.n_classes} classes")
    check(state.step == HEAD_CLI_STEPS, f"head widths CLI ended at step {state.step}")
    want = scene_expected_launches(trainer, HEAD_CLI_STEPS, pipeline.ds_drop_step)
    check(got == want, f"head widths CLI launches {got}, expected {want}")
    check(not any(plain.values()), f"head widths CLI: a plain version ran: {plain}")
    hist = trainer.history
    check(len(hist) == HEAD_CLI_STEPS
          and all(math.isfinite(v) for h in hist for v in h.values()),
          "head widths CLI: missing or non-finite loss terms")
    return {"steps": HEAD_CLI_STEPS, "scene": HEAD_SCENE, "classes": HEAD_CLASSES,
            "tau": cfg.t_embedding_tau, "out_w": spec.out_w, "aux_pad": spec.aux_pad,
            "depth_drop_step": pipeline.ds_drop_step, "seconds": seconds,
            "loop_ms_per_step": trainer.ms_per_step, "launches": got, "plain_calls": plain,
            "metrics_last": hist[-1]}


def _head_cell(dev, feat: int, fl: int, tau: int, n_classes: int, n: int):
    """(key, field, spec, inputs) of the rs_semantic TOML at (feat, fl)
    with a t-embedding ``tau`` wide (at 62 the separate semantic one too)
    and ``n_classes`` classes, heads past 16 columns on K1: seeded weights
    and ``n`` seeded inputs for width_kernel_checks."""
    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models.field import Field, fused_field_spec, use_fused_field

    key = f"tau{tau}_c{n_classes}/{feat}x{fl}"
    rcfg = load_render_config(PIPELINE_TOML, n_classes=n_classes, device=dev,
                              trunk_impl="pallas", fc_units=feat,
                              fc_use_full_features=fl == feat, t_embedding_tau=tau,
                              use_tj_for_s=True, use_separate_tj_for_semantic=tau == 62)
    fcfg = rcfg.field
    spec = fused_field_spec(fcfg)
    check(use_fused_field(fcfg) and fcfg.feat_last == fl and spec.tau == tau
          and spec.n_classes == n_classes and spec.out_w > 16 and spec.aux_pad > 16,
          f"{key} route")
    field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    inputs = _width_inputs(fcfg, n, tau + n_classes + feat, dev, spec.out_w)
    inputs += (torch.randn(n, tau, generator=torch.Generator().manual_seed(tau))
               .to(dev),)  # the separate semantic t-embedding
    return key, field, spec, inputs


def head_widths_phase(dev, vocab: int, turns: list | None) -> dict:
    """Head widths past 16 columns (HEAD_CASES: t-embeddings 7, 16 and 62
    wide, 8, 12 and 119 classes; at 62 the separate semantic t-embedding
    too) at HEAD_PAIRS, f32 and bf16, HEAD_POINTS points: K1 (both head
    variants) with K2 and K4 (both engines) on K1's residuals against their
    plain versions within today's bars, each run twice bitwise equal
    (width_kernel_checks); K1's and K2's device ms beside their bounds
    (width_times); then the rs_semantic TOML at HEAD_STEP and HEAD_CLASSES
    classes: five flagship training steps (train_phase: K1, K2, K4, K5 and
    its backward every step, no plain version, a 32-ray step against the
    CPU), one 128 x 128 request (serve_variant_phase) and the training CLI on
    a scene with HEAD_CLASSES labels (head_widths_cli_run). With ``turns``,
    K1-K4's outputs at the flagship against the parent build's
    (parent_outputs_check)."""
    import shutil
    import tempfile

    import torch

    from satnerf_torch.models.field import fused_field_spec

    t_phase = time.monotonic()
    cells, notes, times = {}, [], {}
    before = read_counters()[0]
    for (feat, fl), (tau, n_classes) in [(p, c) for p in HEAD_PAIRS for c in HEAD_CASES]:
        key, field, spec, inputs = _head_cell(dev, feat, fl, tau, n_classes, HEAD_POINTS)
        with torch.no_grad():
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                packed = field.packed(dt)
                cells.setdefault(key, {})[dname] = width_kernel_checks(
                    key, spec, True, packed, inputs, dname, HEAD_POINTS, notes)
                times.setdefault(key, {})[dname] = width_times(
                    spec, True, packed, inputs, dname, only=("field_fused", "heads_bwd"))
        del field, inputs
        torch.cuda.empty_cache()
    after = read_counters()[0]
    check_launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    checks_s = time.monotonic() - t_phase

    step = train_phase(dev, vocab, "train_heads", HEAD_STEP, PER_STEP, stored_check=False,
                       n_classes=HEAD_CLASSES)
    spec = fused_field_spec(step["scfg"].render.field)
    check((spec.tau, spec.n_classes, spec.out_w) == (16, HEAD_CLASSES, 32),
          f"head widths step field: tau {spec.tau}, {spec.n_classes} classes")
    serve = serve_variant_phase("serve_heads", dev, step["scfg"].render, step["params"], vocab,
                                {"field_fused": 1, "trunk_fwd": 0, "composite": 1,
                                 "trunk_fwd_interleaved": 0})
    work = tempfile.mkdtemp(prefix="head_widths_")
    try:
        cli = head_widths_cli_run(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    parent = None
    if turns:
        bitwise = parent_outputs_check("at the flagship")
        mine, theirs = turn_means(turns)
        keys = ("field_fused", "field_fused_serve", "heads_bwd")
        parent = {"outputs_vs_parent_flagship": bitwise,
                  "this_ms_flagship": {k: v for k, v in mine.items() if k.split("/")[0] in keys},
                  "parent_ms_flagship": {k: v for k, v in theirs.items()
                                         if k.split("/")[0] in keys}}
    line = {"phase": "head_widths", "cases": HEAD_CASES, "pairs": HEAD_PAIRS,
            "points": HEAD_POINTS, "errors": cells, "notes": notes, "times": times,
            "check_launches": check_launches,
            "step": {"launches": step["launches"], **HEAD_STEP, "n_classes": HEAD_CLASSES},
            "serve": serve, "cli": cli, "parent": parent, "checks_seconds": checks_s,
            "seconds": time.monotonic() - t_phase,
            "tol": {"forward": TOL_FIELD, "backward": TOL_FIELD_BWD, "residuals": TOL_RESID,
                    "relu_kink": TOL_KINK}}
    emit(line)
    return line


def wide_kernel_checks(key: str, spec, packed, inputs, dname: str, fused: bool,
                       notes: list) -> dict:
    """At each of WIDE_POINTS: K1 with K2 and K4 (fused widths) and K3 (every
    width; with K4 where K1's residuals did not already feed it), each
    against its plain version within today's bars and run twice, bitwise
    equal (width_kernel_checks). -> {check: its largest error over the
    points}."""
    worst = {}
    for n in WIDE_POINTS:
        for route in ((True, False) if fused else (False,)):
            for k, e in width_kernel_checks(key, spec, route, packed, inputs, dname, n,
                                            notes, k4=not fused).items():
                worst[k] = max(worst.get(k, 0.0), e)
    return worst


def wide_widths_phase(dev, vocab: int) -> dict:
    """Trunks wider than 512 (WIDE_PAIRS, 640-1,024, the rs_semantic TOML's
    8 layers, skip at 4), f32 and bf16, at WIDE_POINTS: K3 and K4 at every
    width, K1 and K2 at the pairs the fused field takes, against their plain
    versions within today's bars, two runs bitwise (wide_kernel_checks);
    their device ms at 65,536 points beside the 3xTF32, FMA and bf16 bounds
    (width_times); K1, K2 and K4 with heads past 16 columns at the fused
    pairs (WIDE_HEAD_CASES at WIDE_HEAD_PAIRS, WIDE_HEAD_POINTS points); K4
    with more skips than one launch takes products (WIDE_SKIPS); then the TOML at fc_units WIDE_STEP_UNITS in f32 and bf16:
    five training steps (train_phase: K1, K2, K4 3 and K5, K5-bwd 2 a step,
    no plain call, a 32-ray step against the CPU) and one 128 x 128 request
    each; and one request at WIDE_K3_UNITS (K3, the heads layer by layer)."""
    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.models.field import (Field, FieldConfig, fused_field_spec,
                                            use_fused_field, use_fused_trunk)
    from satnerf_torch.train.state import init_params

    t_phase = time.monotonic()
    cells, notes, times = {}, [], {}
    before = read_counters()[0]
    for feat, fl in WIDE_PAIRS:
        key = f"{feat}x{fl}"
        rcfg = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas", fc_units=feat)
        fcfg = rcfg.field
        fused = use_fused_field(fcfg)
        check(fcfg.feat_last == fl and (fused or use_fused_trunk(fcfg)), f"{key} route")
        field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
        spec = fused_field_spec(fcfg)
        inputs = _width_inputs(fcfg, max(WIDE_POINTS), feat + fl, dev)
        with torch.no_grad():
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                packed = field.packed(dt)
                cells.setdefault(key, {})[dname] = wide_kernel_checks(
                    key, spec, packed, inputs, dname, fused, notes)
                times.setdefault(key, {})[dname] = {
                    **width_times(spec, False, packed, inputs, dname,
                                  only=None if not fused else ("trunk_fwd",)),
                    **(width_times(spec, True, packed, inputs, dname) if fused else {})}
        del field, inputs
        torch.cuda.empty_cache()
    for (feat, fl), (tau, n_classes) in [(p, c) for p in WIDE_HEAD_PAIRS
                                         for c in WIDE_HEAD_CASES]:
        key, field, spec, inputs = _head_cell(dev, feat, fl, tau, n_classes, WIDE_HEAD_POINTS)
        with torch.no_grad():
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                cells.setdefault(key, {})[dname] = width_kernel_checks(
                    key, spec, True, field.packed(dt), inputs, dname, WIDE_HEAD_POINTS, notes)
        del field, inputs
        torch.cuda.empty_cache()
    for skips in WIDE_SKIPS:  # K4's gx launch chained past MAX_PRODS products
        key = "skips" + "".join(map(str, skips))
        fcfg = FieldConfig(variant="rs_semantic", layers=8, feat=256, skips=skips, mapping=True,
                           trunk_impl="pallas")
        field = Field(fcfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
        spec = fused_field_spec(fcfg)
        inputs = _width_inputs(fcfg, max(WIDE_POINTS), len(skips), dev)
        with torch.no_grad():
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                cells.setdefault(key, {})[dname] = width_kernel_checks(
                    key, spec, False, field.packed(dt), inputs, dname, max(WIDE_POINTS), notes)
        del field, inputs
    after = read_counters()[0]
    check_launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    checks_s = time.monotonic() - t_phase

    paths = {}
    for units in WIDE_STEP_UNITS:
        for dname in ("float32", "bfloat16"):
            name = f"wide{units}_{dname}"
            step = train_phase(dev, vocab, f"train_{name}",
                               {"fc_units": units, "compute_dtype": dname}, PER_STEP,
                               stored_check=False)
            fcfg = step["scfg"].render.field
            check(fcfg.feat == units and use_fused_field(fcfg), f"{name} field {fcfg.feat}")
            serve = serve_variant_phase(f"serve_{name}", dev, step["scfg"].render,
                                        step["params"], vocab,
                                        {"field_fused": 1, "trunk_fwd": 0, "composite": 1,
                                         "trunk_fwd_interleaved": 0}, n_cmp=WIDE_CPU_RAYS)
            paths[name] = {"step_launches": step["launches"], "serve": serve}
    rcfg = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas",
                              fc_units=WIDE_K3_UNITS)
    check(use_fused_trunk(rcfg.field), f"{WIDE_K3_UNITS} wide: the K3 route")
    params = init_params(torch.Generator().manual_seed(0), rcfg.field, t_vocab=vocab, device=dev)
    paths[f"serve_wide{WIDE_K3_UNITS}"] = serve_variant_phase(
        f"serve_wide{WIDE_K3_UNITS}", dev, rcfg, params, vocab,
        {"field_fused": 0, "trunk_fwd": 1, "composite": 1, "trunk_fwd_interleaved": 0},
        n_cmp=WIDE_CPU_RAYS)
    line = {"phase": "wide_widths", "pairs": WIDE_PAIRS, "points": WIDE_POINTS,
            "head_cases": WIDE_HEAD_CASES, "head_pairs": WIDE_HEAD_PAIRS,
            "head_points": WIDE_HEAD_POINTS, "skips": WIDE_SKIPS, "errors": cells, "notes": notes, "times": times,
            "check_launches": check_launches, "paths": paths, "checks_seconds": checks_s,
            "seconds": time.monotonic() - t_phase,
            "tol": {"forward": TOL_FIELD, "backward": TOL_FIELD_BWD, "residuals": TOL_RESID,
                    "relu_kink": TOL_KINK, "step_bf16": TOL_STEP_BF16,
                    "serve_bf16": TOL_SERVE_CPU_BF16}}
    emit(line)
    return line


def main() -> int:
    argv = sys.argv[1:]
    if "--tree" in argv:
        return child_times(argv[argv.index("--tree") + 1], argv[argv.index("--save") + 1])
    if "--dp-rank" in argv:
        i = argv.index("--dp-rank")
        return dp_rank_main(*argv[i + 1 : i + 5])
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from satnerf_torch.configs import load_render_config
        from satnerf_torch.core.encoding import positional_encoding
        from satnerf_torch.device import disable_tf32
        from satnerf_torch.models.embeddings import init_embedding
        from satnerf_torch.models.field import Field, fused_field_spec, use_fused_trunk
        from satnerf_torch.ops import _build, composite as comp_mod
        from satnerf_torch.ops import field_fused as ff
        from satnerf_torch.ops.fastmath import COSINE_ENGINES, SINE_ENGINES
        from satnerf_torch.render.renderer import render_image_chunked, render_rays
        from satnerf_torch.serve.service import RenderService
    except ImportError as exc:
        print(f"chip_smoke: the satnerf_torch package is missing: {exc}",
              file=sys.stderr)
        return 2
    from dataclasses import replace

    disable_tf32()
    count_replays()
    dev = torch.device("cuda")
    marks = [("start", time.monotonic())]
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ---- 2. build -----------------------------------------------------------
    t0 = time.monotonic()
    per_lib = _build.build_all()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 2),
          "per_source_seconds": {k: round(v, 2) for k, v in per_lib.items()},
          "build_dir": os.path.relpath(_build.build_dir(), REPO)})
    marks.append(("build", time.monotonic()))
    # the libraries on the tensor cores: HGMMA (wgmma) instructions in each
    # kernel's SASS, and ptxas's registers and spills
    tc_libs = {"field_bwd": ("row_ws_kernel", "reduce_ws_kernel"),
               "trunk_bwd": ("row_ws_kernel", "reduce_ws_kernel"),
               "field_fused": ("field_fused_kernel",),
               "trunk_fwd": ("trunk_fwd_kernel", "trunk_fwd_il_kernel")}
    sass = {lib: _build.sass_counts(lib) for lib in tc_libs}
    ptxas = {lib: _build.ptxas_report(lib) for lib in tc_libs}
    k6_regs = {k: v.get("registers") for k, v in ptxas["trunk_fwd"].items()
               if "trunk_fwd_il_kernel" in k}
    # ptxas's notes on the wgmma pipelines (serialised groups, injected waits)
    notes = {}
    for lib in tc_libs:
        with open(os.path.join(_build.build_dir(), f"{lib}.log")) as f:
            notes[lib] = sorted({ln.split("ptxas info    : ")[-1].split(" in the function")[0]
                                 .split(" in function")[0].strip() + " | " + ln.split("'")[-2]
                                 for ln in f if "(C75" in ln and "'" in ln})
    emit({"phase": "build_bwd_sass", "hgmma_per_kernel": sass, "ptxas": ptxas,
          "ptxas_wgmma_notes": notes, "k6_registers_per_thread": k6_regs})
    check(len(k6_regs) == 2, f"K6: {len(k6_regs)} instances in the ptxas report")
    for lib, names in tc_libs.items():
        check(isinstance(sass[lib], dict), f"{lib}: no SASS listing ({sass[lib]})")
        tc_kernels = {k: n for k, n in sass[lib].items() if any(p in k for p in names)}
        check(len(tc_kernels) > 0 and all(n > 0 for n in tc_kernels.values()),
              f"{lib}: a tensor-core kernel has no HGMMA: {tc_kernels}")
        check(all(r.get("spill_stores", 0) == 0 for r in ptxas[lib].values()),
              f"{lib}: a kernel spills")

    # ---- 3. sine engines ------------------------------------------------------
    import ctypes

    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.cat([torch.linspace(-1e3, 1e3, 1 << 20),
                   (torch.rand(1 << 20, generator=g) * 2 - 1) * 1e3]).to(dev)
    lib = _build.load_library("sine_check")
    sine_err = {}
    for mode, name in enumerate(ff.SIN_MODES):
        for cosine, engines in ((0, SINE_ENGINES), (1, COSINE_ENGINES)):
            y = torch.empty_like(x)
            err = lib.sine_eval(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                                x.numel(), mode, cosine,
                                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            check(err == 0, f"sine_eval launch error {err}")
            torch.cuda.synchronize()
            key = f"{'cos' if cosine else 'sin'}_{name}"
            sine_err[key] = float((y - engines[name](x)).abs().max())
            check(sine_err[key] <= TOL_SINE, f"{key} err {sine_err[key]}")
    emit({"phase": "sine", "n": x.numel(), "range": 1e3, "max_abs_err": sine_err,
          "tol": TOL_SINE})

    # ---- 4. fused field vs plain at the flagship width -------------------------
    rcfg = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas")
    fcfg = rcfg.field
    vocab = 50
    gen = torch.Generator().manual_seed(0)
    field = Field(fcfg, generator=gen).to(dev).eval()
    table = init_embedding(vocab, fcfg.t_embedding_tau, generator=gen)
    spec = fused_field_spec(fcfg)

    def field_inputs(n: int, seed: int):
        gi = torch.Generator().manual_seed(seed)
        xyz = torch.rand(n, 3, generator=gi) * 2 - 1
        sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=gi), dim=1)
        t_emb = torch.randn(n, fcfg.t_embedding_tau, generator=gi)
        return positional_encoding(xyz, fcfg.mapping_pos_n_freq).to(dev), \
            sun.to(dev), t_emb.to(dev)

    groups = {"sigma": (ff.COL_SIGMA, 1), "rgb": (ff.COL_RGB, 3),
              "sun": (ff.COL_SUN, 1), "sky": (ff.COL_SKY, 3),
              "beta": (ff.COL_BETA, 1), "semantic": (ff.COL_SEM, fcfg.n_classes)}
    enc, sun_d, t_emb = field_inputs(max(FIELD_CHECK_POINTS), 1)
    # both instantiated head widths: the flagship's 256 and, with
    # fc_use_full_features, 512
    fcfg_fl512 = replace(fcfg, fc_use_full_features=True)
    field_fl512 = Field(fcfg_fl512, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    field_err = {}
    with torch.inference_mode():
        for fld, cfg_fl in ((field, fcfg), (field_fl512, fcfg_fl512)):
            sp_fl = fused_field_spec(cfg_fl)
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                packed = fld.packed(dt)
                for heads_on in (True, False):
                    sp = replace(sp_fl, heads_on=heads_on)
                    for n in FIELD_CHECK_POINTS:
                        xk = ff.pack_x(sp, enc[:n], dt)
                        aux = ff.pack_aux(sp, sun_d[:n], t_emb[:n], None, dt)
                        out_k = ff.fused_field(sp, xk, aux, packed)
                        again = ff.fused_field(sp, xk, aux, packed)
                        torch.cuda.synchronize()
                        out_p = ff.fused_field_reference(sp, xk, aux, packed)
                        key = f"fl{sp.fl}/{dname}/heads_{'on' if heads_on else 'off'}/n{n}"
                        check(bool(torch.isfinite(out_k).all()), f"field {key} non-finite")
                        check(torch.equal(out_k, again), f"field {key}: two runs differ")
                        errs = {k: float((out_k[:, c:c + w] - out_p[:, c:c + w]).abs().max())
                                for k, (c, w) in groups.items()}
                        field_err[key] = errs if n == max(FIELD_CHECK_POINTS) else max(
                            errs.values())
                        check(max(errs.values()) <= TOL_FIELD[dname], f"field {key} err {errs}")
    del field_fl512
    emit({"phase": "field_fused_check", "points": FIELD_CHECK_POINTS, "layers": spec.layers,
          "feat": spec.feat, "c_in": spec.c_in, "fl": [spec.fl, 512],
          "n_classes": spec.n_classes, "bitwise_repeat": True, "max_abs_err": field_err,
          "tol": TOL_FIELD})

    # ---- 5. composite vs plain -------------------------------------------------
    def comp_inputs(b: int, s: int, seed: int):
        gc = torch.Generator().manual_seed(seed)
        sig = torch.rand(b, s, generator=gc) * 6 - 1  # some negative densities
        z = torch.sort(torch.rand(b, s, generator=gc) * 2, dim=1).values
        alb = torch.rand(b, s, 3, generator=gc)
        sun = torch.rand(b, s, generator=gc)
        sky = torch.rand(b, 3, generator=gc)
        return [t.to(dev) for t in (sig, z, alb, sun, sky)]

    # the main path's four shapes and ragged ones, with the renderer's strided
    # sun/sky views; two runs and a run on contiguous copies bit for bit equal
    comp_err = {}
    names = ("weights", "transparency", "depth", "rgb")
    for b, s in K5_SHAPES + K5_RAGGED:
        args = k5_inputs(b, s, b + s, dev)
        outs_k = comp_mod.composite(*args)
        again = comp_mod.composite(*args)
        flat = comp_mod.composite(*(t.contiguous() for t in args))
        torch.cuda.synchronize()
        outs_p = comp_mod.composite_reference(*args)
        check(all(torch.equal(x, y) for x, y in zip(outs_k, again)),
              f"composite {b}x{s}: two runs differ")
        check(all(torch.equal(x, y) for x, y in zip(outs_k, flat)),
              f"composite {b}x{s}: strided and contiguous inputs differ")
        errs = {n: float((a - r).abs().max()) for n, a, r in zip(names, outs_k, outs_p)}
        comp_err[f"{b}x{s}"] = errs
        for n in names:
            check(errs[n] <= TOL_COMPOSITE[n], f"composite {b}x{s} {n} {errs[n]}")
    emit({"phase": "composite_check", "max_abs_err": comp_err, "bitwise_repeat": True,
          "strided_sun_sky": True, "tol": TOL_COMPOSITE})

    # ---- 6. serve ----------------------------------------------------------------
    svc = RenderService({"field": field, "t": table}, rcfg, chunk=CHUNK, device=dev)
    n_rays = SERVE_H * SERVE_W
    requests = [synthetic_rays(n_rays, 100 + i, vocab) for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    ff.LAUNCHES = 0
    comp_mod.LAUNCHES = 0
    preps0 = ff.trunk.TC_PREPARATIONS
    results, req_ms = [], []
    for rays, extras in requests:
        t0 = time.monotonic()
        results.append(svc.render_rays(rays, extras, SERVE_H, SERVE_W))
        req_ms.append((time.monotonic() - t0) * 1e3)
    launches = {"field_fused": ff.LAUNCHES, "composite": comp_mod.LAUNCHES}
    serve_preps = ff.trunk.TC_PREPARATIONS - preps0
    chunks = N_REQUESTS * (-(-n_rays // CHUNK))
    for out in results:
        for k, v in out.items():
            if v.dtype.kind == "f":
                check(bool(np.isfinite(v).all()), f"serve {k} non-finite")
        check(out["rgb"].min() >= 0.0 and out["rgb"].max() <= 1.0, "rgb outside [0,1]")
        check(out["rgb"].shape == (SERVE_H, SERVE_W, 3), "rgb shape")
    check(launches["field_fused"] >= chunks and launches["composite"] >= chunks,
          f"kernels not on the serve path: {launches} for {chunks} chunks")

    # the first 1,024 rays against the plain path on CPU copies
    cpu_field = Field(fcfg)
    cpu_field.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    n_cmp = 1024
    rays0, extras0 = requests[0]
    ref = render_image_chunked({"field": cpu_field, "t": table}, svc.rcfg,
                               rays0[:n_cmp], extras0[:n_cmp], chunk=n_cmp,
                               device="cpu")
    got = results[0]
    cpu_err = {
        "rgb": float(np.abs(got["rgb"].reshape(-1, 3)[:n_cmp] - ref["rgb"]).max()),
        "depth": float(np.abs(got["depth"].reshape(-1)[:n_cmp] - ref["depth"]).max()),
    }
    label_agree = float(np.mean(
        got["semantic_label"].reshape(-1)[:n_cmp] == ref["semantic_label"]))
    for k, tol in TOL_SERVE_CPU.items():
        check(cpu_err[k] <= tol, f"serve vs CPU {k} err {cpu_err[k]}")
    check(label_agree >= 0.99, f"semantic labels agree on {label_agree}")
    emit({"phase": "serve", "requests": N_REQUESTS, "rays_per_request": n_rays,
          "chunk": CHUNK, "launches": launches, "preparations": serve_preps,
          "request_ms": req_ms,
          "rays_per_s": n_rays * N_REQUESTS / (sum(req_ms) / 1e3),
          "stats": svc.stats(), "cpu_plain_max_abs_err": cpu_err,
          "cpu_label_agreement": label_agree, "tol": TOL_SERVE_CPU})

    # one render with solar correction: the heads_on=False variant on its path
    sc_cfg = replace(svc.rcfg, solar_correction=True)
    rays_t = torch.from_numpy(requests[1][0]).to(dev)
    extras_t = torch.from_numpy(requests[1][1]).to(dev)
    before = ff.LAUNCHES
    with torch.inference_mode():
        sc = render_rays(svc.params, sc_cfg, rays_t, extras_t)
        torch.cuda.synchronize()
    sc_launches = ff.LAUNCHES - before
    check(sc_launches == 2, f"solar-correction render made {sc_launches} field launches")
    sc_np = {k: v.float().cpu().numpy() for k, v in sc.items()}
    for k, v in sc_np.items():
        check(bool(np.isfinite(v).all()), f"sc {k} non-finite")
    with torch.inference_mode():
        ref_sc = render_rays({"field": cpu_field, "t": table}, sc_cfg,
                             rays_t[:256].cpu(), extras_t[:256].cpu())
    sc_err = {k: float(np.abs(sc_np[k][:256] - ref_sc[k].numpy()).max())
              for k in ("weights_sc", "transparency_sc", "sun_sc", "rgb", "depth")}
    for k, v in sc_err.items():
        check(v <= 1e-4, f"sc render vs CPU {k} err {v}")
    emit({"phase": "solar_correction_render", "rays": rays_t.shape[0],
          "field_launches": sc_launches, "cpu_plain_max_abs_err_256_rays": sc_err})

    # ---- 7. times at the serve shapes ---------------------------------------------
    n_pts = CHUNK * rcfg.n_samples
    enc_t, sun_t, temb_t = field_inputs(n_pts, 2)
    times = {}
    with torch.inference_mode():
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            packed = field.packed(dt)
            xk = ff.pack_x(spec, enc_t, dt)
            aux = ff.pack_aux(spec, sun_t, temb_t, None, dt)
            k_ms = cuda_ms(lambda: ff.fused_field(spec, xk, aux, packed), reps=3)
            p_ms = cuda_ms(lambda: ff.fused_field_reference(spec, xk, aux, packed),
                           reps=3)
            # the same comparison as phase 4, at the serve chunk's shape
            err = float((ff.fused_field(spec, xk, aux, packed)
                         - ff.fused_field_reference(spec, xk, aux, packed))
                        .abs().max())
            check(err <= TOL_FIELD[dname], f"field {dname} at {n_pts} points err {err}")
            flops = 2.0 * spec.mac_per_point() * n_pts
            weight_bytes = sum(t.numel() * t.element_size() for t in packed.values())
            io_bytes = (xk.numel() + aux.numel()) * xk.element_size() + n_pts * 16 * 4
            bounds = op_bounds(flops, dname)
            ops_ms = bounds.pop("ops_ms")
            bytes_ms = (io_bytes + weight_bytes) / PEAK_HBM_BYTES * 1e3
            times[dname] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **bounds,
                "max_abs_err": err, "flops": flops, "bytes": io_bytes + weight_bytes,
                "achieved_tflops": flops / (k_ms * 1e-3) / 1e12,
            }
            del xk, aux
    emit({"phase": "field_fused_time", "points": n_pts,
          "mac_per_point": spec.mac_per_point(),
          "sines_per_point": spec.sines_per_point(), "times": times})

    # K5's device times at its four shapes (this tree; the parent's in turns
    # in phase composite_device_times)
    k5 = composite_times(dev)
    cargs = comp_inputs(CHUNK, rcfg.n_samples, 7)
    b, s = CHUNK, rcfg.n_samples
    c_ms = k5[f"composite/{b}x{s}"]["ms"]
    cp_ms = cuda_ms(lambda: comp_mod.composite_reference(*cargs), reps=50, warmup=3)
    c_bytes = k5_bytes(b, s)[0]
    c_flops = 25.0 * b * s  # per sample: alpha, scan, weight, depth, 3 irradiance terms
    c_bytes_ms = c_bytes / PEAK_HBM_BYTES * 1e3
    c_ops_ms = c_flops / PEAK_F32_FLOPS * 1e3
    emit({"phase": "composite_time", "shape": [b, s], "ms": c_ms, "plain_ms": cp_ms,
          "host_issue_us": k5[f"composite/{b}x{s}"]["host_issue_us"],
          "bytes": c_bytes, "bound_ms": max(c_bytes_ms, c_ops_ms)})

    # ---- 8. backward kernels -----------------------------------------------------
    bwd_err = field_backward_phase(field, fcfg, enc, sun_d, t_emb)
    comp_bwd_err = composite_backward_phase(dev)
    marks.append(("kernel_checks_serve_times", time.monotonic()))

    # ---- 9. training ------------------------------------------------------------------
    train = train_phase(dev, vocab)
    turns = run_turns(parent) if parent else None
    if turns:
        mine, theirs = turn_means(turns)
        emit({"phase": "step_turns", "steps": 5,
              "turns_ms": {k: [t["times"][k]["ms"] for t in turns]
                           for k in turns[0]["times"] if k.startswith("step/")},
              "this_ms": {k: v for k, v in mine.items() if k.startswith("step/")},
              "parent_ms": {k: v for k, v in theirs.items() if k.startswith("step/")}})
    train_t = train_times_phase(dev, train["scfg"], train["params"], turns, k5)
    k5_line = composite_device_phase(turns, k5)
    profile_phase(dev, train["scfg"], train["params"], vocab)
    marks.append(("train_times_profile", time.monotonic()))

    # ---- 10. the trunk-only kernel K3 and its interleaved variant K6 ------------------
    rcfg_b = load_render_config(PIPELINE_TOML, device=dev, trunk_impl="pallas", **BETA_S)
    check(use_fused_trunk(rcfg_b.field), "the beta_s field runs K3")
    field_b = Field(rcfg_b.field, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    spec_b = fused_field_spec(rcfg_b.field)
    trunk_chk = trunk_forward_phase(dev, field_b, spec_b, enc)

    # ---- 11. Path A: the beta_s ablation field, trained and served through K3 -------
    beta_s = train_phase(dev, vocab, "train_beta_s", BETA_S, PER_STEP_BETA_S,
                         stored_check=False)
    serve_b = serve_variant_phase("serve_beta_s", dev, beta_s["scfg"].render,
                                  beta_s["params"], vocab,
                                  {"field_fused": 0, "trunk_fwd": 1, "composite": 1,
                                   "trunk_fwd_interleaved": 0})

    # ---- 12. Path B: the hierarchical configuration, trained and served ---------------
    # one K1 weight preparation per field and step (coarse, fine), not per call
    hier = train_phase(dev, vocab, "train_hier", HIER, PER_STEP_HIER, stored_check=False,
                       preparations=2)
    serve_h = serve_variant_phase("serve_hier", dev, hier["scfg"].render, hier["params"],
                                  vocab, {"field_fused": 2, "trunk_fwd": 0, "composite": 2,
                                          "trunk_fwd_interleaved": 0},
                                  coarse=True, fields=2)

    # ---- 13. K3 and K6 times -----------------------------------------------------------
    trunk_t = trunk_times_phase(dev, field_b, spec_b, lambda n: field_inputs(n, 3)[0], turns)
    marks.append(("k3_k6_paths_a_b", time.monotonic()))

    # ---- 13b. every trunk width below 512: the kernels against their plain
    # versions, their times, the four-scene training at 8 x 256 through the CLI,
    # the examples' 2 x 128 step ----
    widths = widths_phase(dev, vocab, turns, per_lib)
    marks.append(("widths", time.monotonic()))
    # ---- 13c. encoded inputs past 64 wide at every trunk width, and the
    # rs_semantic TOML trained and served at 12 frequencies ----
    input_widths = input_widths_phase(dev, vocab, turns)
    marks.append(("input_widths", time.monotonic()))
    # ---- 13d. head widths past 16 columns (t-embeddings to 62, 8 to 119 classes):
    # K1, K2, K4 against their plain versions, K1/K2 times, the rs_semantic TOML
    # at tau 16 and 12 classes trained, served and run through the CLI ----
    head_widths = head_widths_phase(dev, vocab, turns)
    marks.append(("head_widths", time.monotonic()))
    # ---- 13e. trunks 640-1,024 wide: K1-K4 against their plain versions, their
    # times, K4 with 7 skips, the TOML at 1,024 and 768 trained and served in
    # f32 and bf16, one request at 640 on K3 ----
    wide = wide_widths_phase(dev, vocab)
    marks.append(("wide_widths", time.monotonic()))

    # ---- 14-20. the training CLI on a generated scene, resume, serving its best;
    # the eval battery on that run; the run served by view name over HTTP; its
    # visualizers re-rendered; the scene over two data-parallel ranks; a sweep;
    # a dataset built by the port from a DFC2019 distribution, trained on and
    # evaluated; 21. the quality tools ----
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="train_scene_")
    try:
        scene = train_scene_phase(dev, work)
        dispatch = train_dispatch_phase(dev, work, {"flagship": train, "path_b": hier}, vocab)
        eval_scene = eval_scene_phase(dev, scene, work)
        serve_view = serve_view_phase(dev, scene)
        viz_scene = viz_scene_phase(dev, scene, work)
        train_dp = train_dp_phase(dev, work)
        sweep = sweep_phase(dev, work)
        os.makedirs(os.path.join(work, "prep"))
        prep = prep_scene_phase(dev, os.path.join(work, "prep"))
        os.makedirs(os.path.join(work, "quality_tools"))
        quality = quality_tools_phase(dev, os.path.join(work, "quality_tools"))
        trained_audit_phase(dev, quality, os.path.join(work, "quality_tools"))
        del quality["fit"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    marks.append(("scene_to_trained_audit", time.monotonic()))

    # ---- 23-25. the measurement scripts: the bench, its variants, the tools ----
    bench_line = bench_phase(dev)
    marks.append(("bench", time.monotonic()))
    variants = bench_variants_phase(dev)
    marks.append(("bench_variants", time.monotonic()))
    tools = tools_phase(dev)
    marks.append(("tools", time.monotonic()))
    emit({"phase": "phase_seconds", "total": marks[-1][1] - marks[0][1],
          **{name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}})

    def by_path(kernel):
        return {"train": train["launches"][kernel], "train_beta_s": beta_s["launches"][kernel],
                "train_hier": hier["launches"][kernel],
                "train_scene": scene["launches"][kernel],
                **{f"train_dispatch_{name}": p["launches"][kernel]
                   for name, p in dispatch["paths"].items()},
                "train_dispatch_cli": dispatch["cli"]["launches"][kernel], "serve_beta_s":
                serve_b["launches"][kernel], "serve_hier": serve_h["launches"][kernel],
                "eval_scene": eval_scene["launches"][kernel],
                "serve_view": serve_view["launches"][kernel],
                "viz_scene": viz_scene["launches"][kernel],
                "train_dp_per_rank": [r[kernel] for r in train_dp["launches_per_rank"]],
                "train_dp_one_process": train_dp["launches_one_process"][kernel],
                "train_dp_nccl": train_dp["launches_nccl_world_of_one"][kernel],
                "sweep": sweep["launches"][kernel], "prep_scene": prep["launches"][kernel],
                "widths_cli_8x256": widths["cli"]["launches"][kernel],
                "widths_examples_step_2x128": widths["examples_step"]["launches"][kernel],
                f"train_posenc{POSENC_FREQ}": input_widths["posenc_step"]["launches"][kernel],
                f"serve_posenc{POSENC_FREQ}": input_widths["posenc_serve"]["launches"][kernel],
                "train_heads_tau16_c12": head_widths["step"]["launches"][kernel],
                "serve_heads_tau16_c12": head_widths["serve"]["launches"][kernel],
                "head_widths_cli_tau16_c12": head_widths["cli"]["launches"][kernel],
                **{f"train_{name}": p["step_launches"][kernel]
                   for name, p in wide["paths"].items() if "step_launches" in p},
                **{f"serve_{name}": p["serve"]["launches"][kernel]
                   for name, p in wide["paths"].items() if "serve" in p},
                f"serve_wide{WIDE_K3_UNITS}":
                    wide["paths"][f"serve_wide{WIDE_K3_UNITS}"]["launches"][kernel],
                "prep_scene_eval": prep["eval_launches"][kernel],
                "quality_tools": quality["launches"][kernel],
                "quality_tools_sin_swap": quality["sin_swap_launches"][kernel],
                "bench": bench_line["launches"][kernel],
                **{f"bench_{name}": v[kernel] for name, v in variants["launches"].items()},
                **{name: tools[name]["launches"][kernel]
                   for name in ("render_bench", "speed_of_light", "feed_rate")}}

    f32 = times["float32"]
    k1t = train_t["field_fused"]
    k3t = trunk_t[f"k3_float32_{TRUNK_TIME_POINTS[1]}"]
    k6_key = f"bfloat16_{K6_POINTS}_c63"
    k6t = trunk_t[f"k6_{k6_key}"]
    k6_checks = list(trunk_chk["k6"].values()) + [
        v for k, v in trunk_t.items() if k.startswith("k6_check_")]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "shape")
    op_keys = ("bound_3xtf32_ms", "bound_f32_fma_ms", "bound_bf16_ms")
    fwd_t = train_t["forward_times"]

    def bwd_line(key):  # f32 at the training shape; bf16, split and yardsticks beside
        f, b = train_t[f"{key}/float32"], train_t[f"{key}/bfloat16"]
        keys = ("ms", "row_ms", "reduce_ms", "bound_ms", "bound_by", "bound_f32_fma_ms",
                "library_ms_blocks", "parent_ms")
        return {**{k: f[k] for k in timed + keys if k in f}, "library_ms": None,
                "bf16": {k: b[k] for k in keys if k in b},
                "blocks_alone": {f"{kind}/{d}": train_t[f"{kind}/{d}"]
                                 for kind in ("row_block", "reduce_block")
                                 for d in ("float32", "bfloat16")}}
    kernels = [
        {
            "name": "field_fused", "route": "cuda",
            "source": "satnerf_torch/csrc/field_fused.cu",
            "replaces": "satnerf_tpu/ops/pallas/field_fused.py:361",
            "launches": train["launches"]["field_fused"],
            "max_abs_err": max([f32["max_abs_err"]]
                               + [max(e.values()) if isinstance(e, dict) else e
                                  for k, e in field_err.items() if "/float32/" in k]),
            **{k: k1t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by") + op_keys},
            "library_ms": None,
            "shape": k1t["shape"],
            "turns": {k: v for k, v in fwd_t.items() if k.startswith("field_fused")},
            "serve": {"launches": launches["field_fused"], "points": n_pts,
                      **{k: f32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")
                         + op_keys},
                      "bf16": {k: times["bfloat16"][k]
                               for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        },
        {
            "name": "heads_bwd", "route": "cuda",
            "source": "satnerf_torch/csrc/field_bwd.cu",
            "replaces": "satnerf_tpu/ops/pallas/field_fused.py:594",
            "launches": train["launches"]["heads_bwd"],
            "max_abs_err": bwd_err["max_abs_err_f32"]["heads"],
            "max_rel_err": bwd_err["max_rel_err"]["heads"],
            **bwd_line("heads_bwd"),
        },
        {
            "name": "trunk_bwd", "route": "cuda",
            "source": "satnerf_torch/csrc/trunk_bwd.cu",
            "replaces": "satnerf_tpu/ops/pallas/trunk.py:445",
            "launches": train["launches"]["trunk_bwd"],
            "max_abs_err": bwd_err["max_abs_err_f32"]["trunk"],
            "max_rel_err": bwd_err["max_rel_err"]["trunk"],
            **bwd_line("trunk_bwd_recompute"),
            "engine": "recompute",
            "stored": bwd_line("trunk_bwd_stored"),
        },
        {
            "name": "composite", "route": "cuda",
            "source": "satnerf_torch/csrc/composite.cu",
            "replaces": "satnerf_tpu/ops/pallas/composite.py:76",
            "launches": train["launches"]["composite"],
            "max_abs_err": max(max(e.values()) for e in comp_err.values()),
            **{k: train_t["composite"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "host_issue_us")},
            "library_ms": None,
            "timing": "device_time (launches queued behind a sleep); plain_ms: cuda_ms",
            "launch_floor_ms": k5_line["launch_floor_ms"],
            "serve": {"launches": launches["composite"], "shape": [CHUNK, rcfg.n_samples],
                      "ms": c_ms, "plain_ms": cp_ms,
                      "bound_ms": max(c_bytes_ms, c_ops_ms)},
            "shapes": {k: v for k, v in k5_line["rows"].items() if k.startswith("composite/")},
        },
        {
            "name": "composite_bwd", "route": "cuda",
            "source": "satnerf_torch/csrc/composite.cu",
            "replaces": "satnerf_tpu/ops/pallas/composite.py:76 (its backward; "
                        "the reference differentiates XLA code)",
            "launches": train["launches"]["composite_bwd"],
            "max_abs_err": max(max(e.values()) for e in comp_bwd_err.values()),
            **{k: train_t["composite_bwd"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "host_issue_us")},
            "library_ms": None,
            "timing": "device_time (launches queued behind a sleep); plain_ms: cuda_ms",
            "launch_floor_ms": k5_line["launch_floor_ms"],
            "shapes": {k: v for k, v in k5_line["rows"].items()
                       if k.startswith("composite_bwd/")},
        },
        {
            "name": "trunk_fwd", "route": "cuda",
            "source": "satnerf_torch/csrc/trunk_fwd.cu",
            "replaces": "satnerf_tpu/ops/pallas/trunk.py:347",
            "launches": beta_s["launches"]["trunk_fwd"],
            "max_abs_err": max([trunk_chk["max_abs_err_f32"]]
                               + [trunk_t[f"k3_float32_{n}"]["max_abs_err"]
                                  for n in TRUNK_TIME_POINTS]),
            **{k: k3t[k] for k in timed + op_keys},
            "library_ms": None,
            "turns": {k: v for k, v in fwd_t.items() if k.startswith("trunk_fwd/")},
            "at_65536": {k: trunk_t[f"k3_float32_{TRUNK_TIME_POINTS[0]}"][k] for k in timed},
            "bf16_at_k6_shape": {k: trunk_t[f"k3_{k6_key}"][k] for k in timed + op_keys},
        },
        {
            "name": "trunk_fwd_interleaved", "route": "cuda",
            "source": "satnerf_torch/csrc/trunk_fwd.cu",
            "replaces": "tools/interleave_trunk_proto.py:59",
            "launches": beta_s["launches"]["trunk_fwd_interleaved"], "on_main_path": False,
            "on_tensor_cores": True, "registers_per_thread": k6_regs,
            "max_abs_err": max([c["max_abs_err"] for k, c in trunk_chk["k6"].items()
                                if k.startswith("float32")]
                               + [trunk_t["k6_check_float32"]["max_abs_err"]]),
            "bitwise_k3": all(c["bitwise_k3"] for c in k6_checks),
            "bitwise_repeat": all(c["bitwise_repeat"] for c in k6_checks),
            **{k: k6t[k] for k in timed + op_keys}, "device_ms": k6t["device_ms"],
            "library_ms": None,
            "shapes": {k: {"ms": trunk_t[f"k6_{k}"]["ms"],
                           "device_ms": trunk_t[f"k6_{k}"]["device_ms"],
                           "k3_ms": trunk_t[f"k3_{k}"]["ms"],
                           "k3_device_ms": trunk_t[f"k3_{k}"]["device_ms"],
                           **{b: trunk_t[f"k6_{k}"][b] for b in ("bound_ms", "bound_by",
                                                                 "plain_ms", "shape")
                              + op_keys}}
                       for k in trunk_t["turns"]},
            "parent_turns": trunk_t.get("k6_parent_turns"),
        },
    ]
    for entry in kernels:
        if entry["name"] in PER_STEP:
            entry["launches_by_path"] = by_path(entry["name"])
        if entry["name"] in widths["by_kernel"]:
            # device ms, bound and launches at each width below 512 (phase widths)
            entry["widths"] = widths["by_kernel"][entry["name"]]
        # device ms and bound at 512 wide by encoded input width, and the
        # launches of phase input_widths' checks and timings
        by_c_in = {c: {d: {k: rows[entry["name"]][k] for k in ("ms", "bound_ms", "bound_by")}
                       for d, rows in per.items() if entry["name"] in rows}
                   for c, per in input_widths["times_512"].items()}
        if any(by_c_in.values()):
            entry["input_widths"] = {
                "padded_c_in_max": ff.trunk.TC_MAX_K,
                "check_launches": input_widths["check_launches"].get(entry["name"], 0),
                "times_512": by_c_in}
        # device ms and bound at each head width (phase head_widths), and the
        # launches of its checks, timings, step, request and CLI run
        by_case = {c: {d: {k: rows[entry["name"]][k] for k in ("ms", "bound_ms", "bound_by")}
                       for d, rows in per.items() if entry["name"] in rows}
                   for c, per in head_widths["times"].items()}
        # device ms beside the bounds at each width past 512 (phase
        # wide_widths), and the launches of its checks and timings
        by_wide = {w: {d: {k: v for k, v in rows[entry["name"]].items()
                           if k != "timed_launches"}
                       for d, rows in per.items() if entry["name"] in rows}
                   for w, per in wide["times"].items()}
        if any(by_wide.values()):
            entry["wide_widths"] = {
                "check_launches": wide["check_launches"].get(entry["name"], 0),
                "times": {w: v for w, v in by_wide.items() if v}}
        if any(by_case.values()):
            entry["head_widths"] = {
                "check_launches": head_widths["check_launches"].get(entry["name"], 0),
                "step_launches": head_widths["step"]["launches"].get(entry["name"], 0),
                "cli_launches": head_widths["cli"]["launches"].get(entry["name"], 0),
                "times": by_case}
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
