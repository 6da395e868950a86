#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (satnerf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the CUDA kernels from ``satnerf_torch/csrc`` and runs, printing one
JSON line per phase:

1. device and toolchain;
2. the kernel build (one nvcc per source, in parallel), with the HGMMA
   (wgmma) count in the SASS of each tensor-core kernel (K1, K2, K3, K4) and
   its registers and spills;
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
   block (with ``--parent DIR``, an older checkout's K1-K4 in turns with
   these, each in its own process, and K1/K3's f32 outputs held against
   its within the field bars; K5's device times and flagship and Path B
   step times in the same turns); phase ``composite_device_times``: K5 and
   its backward beside the card's empty-kernel launch time, their byte
   bound and ``torch.profiler``'s device time; the K1/K3 weight preparations of every step (one per field);
   ``torch.profiler`` over two steady steps (kernels by device time, the
   device's idle share);
10. the trunk-only kernel K3 against its plain version at the flagship
   width (f32 and bf16, with and without the "stored" pre-activations, at
   1, 63, 64, 65 and 65,537 points, each run twice for bitwise-equal
   results) and its interleaved variant K6 (run twice, bitwise equal, and
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
13. CUDA-event times of K3 and its plain version at the training shapes,
   and of K6 against K3 at the interleave prototype's shape;
14. ``train_scene``: the training CLI end to end on a generated scene (4 + 1
   views, 96x96, 300 tie points): ``run.training.start_training`` on the
   flagship TOML as it is, 144 steps (the depth drop at step 36, the beta
   gate at epoch 2), validation with PSNR, SSIM and the DSM MAE every epoch,
   checkpoints; the launches of K1, K2, K4, K5 and K5's backward by the
   step and validation schedule and no plain version, one K1 weight
   preparation per step and per validation, finite loss terms, the batch's
   plain rgb MSE falling and the train PSNR rising, the run layout,
   the native host library loaded; the same run stopped by
   ``request_stop`` at step 72 and resumed by ``run.resume_training``
   (params bitwise equal to the uninterrupted run's); the ``best``
   checkpoint served by ``RenderService.from_checkpoint`` against that
   validation's render; the loop's host-clock ms per step, seconds per
   validation, DSM/MAE and checkpoint save/restore, and peak memory;
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
   (``build_view_rays``, the render, PNG and HTTP) and rays/s.

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
TOL_STORED = 1e-4  # "stored" vs "recompute" gradients, relative, f32

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
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def field_backward_phase(field, fcfg, enc, sun_d, t_emb) -> dict:
    """K1's residuals, K2 and K4 against their plain versions at the flagship
    width, every dtype, head variant and trunk engine; each run twice."""
    import dataclasses

    import torch

    from satnerf_torch.models.field import fused_field_spec
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    n = enc.shape[0]
    g_out = torch.randn(n, ff.OUT_W, generator=torch.Generator().manual_seed(3))
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
                                     **dict(zip(("gx", "w0", "w_mid", "w_skip", "b"), t))})
                    bitwise = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
                    ro, rs, ra = ff._reference_forward(spec, x, aux, packed, True)
                    rh = ff.heads_backward_reference(spec, shared, aux, g_out, packed)
                    rt = trunk.trunk_backward_reference(spec, x, packed, acts, rh[0])
                    ref = {"g_shared": rh[0], "g_aux": rh[1], **rh[2],
                           **dict(zip(("gx", "w0", "w_mid", "w_skip", "b"), rt))}
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
                        part = "trunk" if k in ("gx", "w0", "w_mid", "w_skip", "b") else "heads"
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


def train_batch(n: int, n_depth: int, seed: int, vocab: int, device) -> dict:
    """A seeded synthetic batch with every key a flagship step reads."""
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
        "semantic": rng.integers(0, 5, (n, 1)),
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


def train_phase(dev, vocab: int, name: str = "train", overrides: dict | None = None,
                per_step: dict = PER_STEP, stored_check: bool = True,
                preparations: int = 1) -> dict:
    """Five training steps of the flagship step config (with ``overrides``
    of its pipeline keys) through the kernels, each preparing the K1/K3
    weights ``preparations`` times (once per field), then a 32-ray step
    against the CPU plain path and, with ``stored_check``, a "stored"-engine
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
    scfg = step_config_from_pipeline(p, steps_per_epoch=1000, n_classes=5, car_index=4,
                                     device=dev)
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
    batch = train_batch(TRAIN_RAYS, TRAIN_RAYS, 5, vocab, dev)
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
    check(set(loss_err) == set(results["cuda"][0]), f"{name}: loss keys differ")
    for k, e in loss_err.items():
        check(e <= TOL_STEP_LOSS, f"{name} 32-ray step {k} card vs CPU {e}")
    for k, (mx, share) in pdiff.items():
        check(mx <= 2 * LR + 1e-6 and share <= 1e-3,
              f"{name} 32-ray step param {k}: {mx} {share}")
    check_line = {"phase": f"{name}_check", "cpu_step_rays": CPU_STEP_RAYS,
                  "loss_rel_err": loss_err,
                  "param_max_abs_err": max(v[0] for v in pdiff.values()),
                  "param_share_beyond_tol": max(v[1] for v in pdiff.values()),
                  "tol": {"loss": TOL_STEP_LOSS, "param": TOL_STEP_PARAM}}
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
        k1_bytes = io + w_bytes + n * (ff.OUT_W + spec.feat) * f4
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


def flagship_case(dev, enc_copies: int = 1) -> dict:
    """The flagship field from seed 0 and seeded inputs at the training shape
    (65,536 points; ``enc_copies`` times as many encoded positions): the
    set-up port_times and bwd_times share."""
    import torch

    from satnerf_torch.configs import load_render_config
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field
    from satnerf_torch.ops import field_fused as ff

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
        "g_out": torch.randn(n, ff.OUT_W, generator=g).to(dev),
    }


def port_times(dev, save: str | None = None, reps: int = 3) -> dict:
    """CUDA-event times at the flagship training shapes of K2 and K4 (both
    engines; 65,536 points, f32 and bf16), each with its row-GEMM launches
    and its reductions summed apart, of K1 with residuals (65,536) and K3
    (131,072), and of K1 at the serve chunk (1,048,576 points), f32 and bf16,
    on a field from seed 0. With ``save``, K1's and K3's
    outputs go to that file. It calls only entry points that every slice of
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
                    g_shared = ff.heads_backward(spec, shared, aux, g_out, packed)[0]
                    out[f"heads_bwd/{dname}"] = split(
                        lambda: ff.heads_backward(spec, shared, aux, g_out, packed))
                    out[f"field_fused/{dname}"] = {"ms": cuda_ms(
                        lambda: ff._forward(spec, x, aux, packed, True), reps=reps)}
                out[f"trunk_bwd_{bwd}/{dname}"] = split(
                    lambda: trunk.trunk_backward(spec, x, packed, acts, g_shared,
                                                 need_gx=False))
                del res, shared, acts
        spec = fused_field_spec(fcfg)
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
        turns.append({"tree": "parent" if tree == parent else "this",
                      "times": json.loads(res.stdout.strip().splitlines()[-1])})
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
    for key, macs in (("heads_bwd", spec.heads_bwd_mac_per_point()),
                      ("trunk_bwd_recompute", dataclasses.replace(
                          spec, trunk_bwd="recompute").trunk_bwd_mac_per_point()),
                      ("trunk_bwd_stored", dataclasses.replace(
                          spec, trunk_bwd="stored").trunk_bwd_mac_per_point())):
        flops = 2.0 * macs * n
        for dname in ("float32", "bfloat16"):
            esz = f4 if dname == "float32" else 2
            if key == "heads_bwd":  # shared, aux, g in; g_shared, g_aux, head grads out
                nbytes = n * (2 * spec.feat + 2 * spec.aux_w) * esz + n * ff.OUT_W * f4 \
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
    fwd = {}
    for k in times:
        if k.startswith(("field_fused", "trunk_fwd")):
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


def profile_phase(dev, scfg, params, vocab: int) -> dict:
    """torch.profiler over two steady flagship steps: the kernels by device
    time and the device's idle share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from satnerf_torch.train.state import create_train_state
    from satnerf_torch.train.step import build_train_step

    state = create_train_state(copy_params(params, dev), LR, "step", scfg.steps_per_epoch)
    step = build_train_step(scfg)
    batch = train_batch(TRAIN_RAYS, TRAIN_RAYS, 5, vocab, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(2):
            state, _ = step(state, batch, gen)
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
    busy = sum(k[1] for k in kernels)
    groups = {"bwd row GEMM (K2+K4)": ("tc_row_kernel", "row_kernel<"),
              "bwd reduction (K2+K4)": ("reduce_kernel", "finish_kernel"),
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
    bitwise-equal results; K6 at the largest size, run twice for
    bitwise-equal results and held against the plain version."""
    import torch

    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    cases = {}
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
            # K6 (the FMA interleaved variant): repeatable and within the bar
            il = trunk.fused_trunk_interleaved(spec, x, packed)
            il2 = trunk.fused_trunk_interleaved(spec, x, packed)
            torch.cuda.synchronize()
            il_err = float((il.float() - ref.float()).abs().max())
            cases[f"{dname}/interleaved"] = {"bitwise_repeat": torch.equal(il, il2),
                                             "max_abs_err": il_err,
                                             "bitwise_k3": torch.equal(il, outs[False])}
            check(torch.equal(il, il2), f"K6 two runs differ in {dname}")
            check(il_err <= TOL_FIELD[dname], f"K6 vs plain in {dname}: {il_err}")
    emit({"phase": "trunk_forward_check", "points": FIELD_CHECK_POINTS, "layers": spec.layers,
          "feat": spec.feat, "c_in": spec.c_in, "cases": cases,
          "tol": {"out": TOL_FIELD, "acts": TOL_RESID}})
    return {"max_abs_err_f32": worst_f32}


def serve_variant_phase(name: str, dev, rcfg, params: dict, vocab: int,
                        per_chunk: dict, coarse: bool = False, fields: int = 1) -> dict:
    """One 128x128 request of a ``RenderService`` over ``params`` through the
    kernels (``per_chunk`` launches of each per 16,384-ray chunk, no plain
    version, the K1/K3 weights of each of its ``fields`` prepared once), its
    first 1,024 rays held against the plain path on CPU copies of the
    weights; with ``coarse``, the hierarchical ``<k>_coarse`` outputs of those
    rays on the card against the CPU's too."""
    import numpy as np
    import torch

    from satnerf_torch.ops import trunk
    from satnerf_torch.render.renderer import render_image_chunked
    from satnerf_torch.serve.service import RenderService

    svc = RenderService(params, rcfg, chunk=CHUNK, device=dev)
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

    n_cmp = 1024
    cpu = copy_params(svc.params, "cpu")
    ref = render_image_chunked(cpu, svc.rcfg, rays[:n_cmp], extras[:n_cmp], chunk=n_cmp,
                               device="cpu")
    err = {"rgb": float(np.abs(out["rgb"].reshape(-1, 3)[:n_cmp] - ref["rgb"]).max()),
           "depth": float(np.abs(out["depth"].reshape(-1)[:n_cmp] - ref["depth"]).max())}
    agree = float(np.mean(out["semantic_label"].reshape(-1)[:n_cmp] == ref["semantic_label"]))
    line = {"phase": name, "rays": n_rays, "chunk": CHUNK, "request_ms": req_ms,
            "rays_per_s": n_rays / (req_ms / 1e3), "launches": got, "preparations": preps,
            "cpu_plain_max_abs_err": err, "cpu_label_agreement": agree,
            "tol": TOL_SERVE_CPU}
    for k, tol in TOL_SERVE_CPU.items():
        check(err[k] <= tol, f"{name} vs CPU {k} err {err[k]}")
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


def trunk_times_phase(dev, field, spec, enc_fn) -> dict:
    """CUDA-event times of K3 and its plain version at the training shapes
    (f32), and of K6 against K3 at the interleave prototype's shape (bf16,
    c_in 63), each beside its bound."""
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

    out = {}
    with torch.no_grad():
        packed = field.packed(torch.float32)
        for n in TRUNK_TIME_POINTS:
            x = ff.pack_x(spec, enc_fn(n), torch.float32)
            k = cuda_ms(lambda: trunk.fused_trunk(spec, x, packed), reps=5)
            pl = cuda_ms(lambda: trunk.fused_trunk_reference(spec, x, packed), reps=2)
            out[f"k3_f32_{n}"] = entry(k, pl, spec, n, x, packed)
            # the same comparison as trunk_forward_check, at the path's shape
            err = float((trunk.fused_trunk(spec, x, packed)
                         - trunk.fused_trunk_reference(spec, x, packed)[0]).abs().max())
            check(err <= TOL_FIELD["float32"], f"trunk f32 at {n} points err {err}")
            out[f"k3_f32_{n}"]["max_abs_err"] = err
            del x

        # K6 against K3: 1,048,576 points, c_in 63, 8x512, skip at 4, bf16, with
        # the prototype's weight scales (normal * 0.02, bias * 0.01, x * 0.5)
        sp = dataclasses.replace(spec, c_in=K6_C_IN)
        g = torch.Generator().manual_seed(21)
        bf = torch.bfloat16

        def rnd(*shape, scale):
            return (torch.randn(*shape, generator=g) * scale).to(dev)

        p6 = {"w0": rnd(sp.cx, sp.feat, scale=0.02), "w_mid": rnd(sp.layers - 1, sp.feat,
                                                                   sp.feat, scale=0.02),
              "w_skip": rnd(len(sp.skips), sp.cx, sp.feat, scale=0.02),
              "b": rnd(sp.layers, sp.feat, scale=0.01)}
        p6["w0"][K6_C_IN:] = 0
        p6["w_skip"][:, K6_C_IN:] = 0
        p6 = {k: (v if k == "b" else v.to(bf)).contiguous() for k, v in p6.items()}
        x6 = rnd(K6_POINTS, sp.cx, scale=0.5)
        x6[:, K6_C_IN:] = 0
        x6 = x6.to(bf).contiguous()
        k3 = trunk.fused_trunk(sp, x6, p6)
        k6 = trunk.fused_trunk_interleaved(sp, x6, p6)
        k6_again = trunk.fused_trunk_interleaved(sp, x6, p6)
        torch.cuda.synchronize()
        bitwise = torch.equal(k6, k6_again)
        check(bitwise, "K6: two runs differ at the prototype's shape")
        ref = trunk.fused_trunk_reference(sp, x6, p6)[0]
        k6_err = float((k6.float() - ref.float()).abs().max())
        k3_err = float((k3.float() - ref.float()).abs().max())
        check(k6_err <= TOL_FIELD["bfloat16"], f"K6 vs plain err {k6_err}")
        check(k3_err <= TOL_FIELD["bfloat16"], f"K3 vs plain err {k3_err} (K6's shape)")
        del k3, k6, k6_again, ref
        turns = []  # K3, K6, K6, K3
        for fn in (trunk.fused_trunk, trunk.fused_trunk_interleaved,
                   trunk.fused_trunk_interleaved, trunk.fused_trunk):
            turns.append(cuda_ms(lambda: fn(sp, x6, p6), reps=5))
        pl6 = cuda_ms(lambda: trunk.fused_trunk_reference(sp, x6, p6), reps=1)
        e3 = entry((turns[0] + turns[3]) / 2, pl6, sp, K6_POINTS, x6, p6)
        e6 = entry((turns[1] + turns[2]) / 2, pl6, sp, K6_POINTS, x6, p6)
        e3["max_abs_err"] = k3_err
        e6.update(max_abs_err=k6_err, bitwise_repeat=bitwise)
        out["k3_bf16_k6_shape"], out["k6_bf16"] = e3, e6
        out["k3_k6_turns_ms"] = turns
    emit({"phase": "trunk_kernel_times", "mac_per_point_c_in_60": macs(spec),
          "mac_per_point_c_in_63": macs(sp), "times": out})
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


def child_times(tree: str, save: str) -> int:
    """``--tree DIR --save FILE``: port_times, composite_times and
    step_times on the checkout at DIR (its own package and kernels), printing
    the times as the last line."""
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        return 2
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.ops import _build

    disable_tf32()
    _build.build_all()
    dev = torch.device("cuda")
    print(json.dumps({**port_times(dev, save), **composite_times(dev), **step_times(dev)}),
          flush=True)
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
        mse_first = sum(10.0 ** (-h["psnr"] / 10.0) for h in hist[:12]) / 12
        mse_last = sum(10.0 ** (-h["psnr"] / 10.0) for h in hist[-12:]) / 12
        check(mse_last < mse_first, f"rgb MSE did not fall: first 12 steps {mse_first}, "
                                    f"last 12 {mse_last}")
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
    want = {k: 0 for k in got}
    want["field_fused"] = want["composite"] = chunks
    check(got == want, f"eval_scene launches {got}, expected {want}")
    check(not any(plain_calls.values()), f"eval_scene: a plain version ran: {plain_calls}")
    check(preps == 1, f"eval_scene: {preps} K1 weight preparations for one load")

    results = {}
    for split in ("train", "test"):
        for kind in ("eval", "eval_semantic"):
            with open(os.path.join(out, name, kind, split, "results.json")) as f:
                results[f"{kind}/{split}"] = json.load(f)
    for key, tree in results.items():
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


def main() -> int:
    argv = sys.argv[1:]
    if "--tree" in argv:
        return child_times(argv[argv.index("--tree") + 1], argv[argv.index("--save") + 1])
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
    dev = torch.device("cuda")
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
    # the libraries on the tensor cores: HGMMA (wgmma) instructions in each
    # kernel's SASS, and ptxas's registers and spills (K6, trunk_fwd_il_kernel,
    # stays on the FMA units)
    tc_libs = {"field_bwd": ("tc_row_kernel", "reduce_kernel"),
               "trunk_bwd": ("tc_row_kernel", "reduce_kernel"),
               "field_fused": ("field_fused_kernel",), "trunk_fwd": ("trunk_fwd_kernel",)}
    sass = {lib: _build.sass_counts(lib) for lib in tc_libs}
    ptxas = {lib: _build.ptxas_report(lib) for lib in tc_libs}
    emit({"phase": "build_bwd_sass", "hgmma_per_kernel": sass, "ptxas": ptxas})
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
    trunk_t = trunk_times_phase(dev, field_b, spec_b, lambda n: field_inputs(n, 3)[0])

    # ---- 14-16. the training CLI on a generated scene, resume, serving its best;
    # the eval battery on that run; the run served by view name over HTTP -----------
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="train_scene_")
    try:
        scene = train_scene_phase(dev, work)
        eval_scene = eval_scene_phase(dev, scene, work)
        serve_view = serve_view_phase(dev, scene)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def by_path(kernel):
        return {"train": train["launches"][kernel], "train_beta_s": beta_s["launches"][kernel],
                "train_hier": hier["launches"][kernel],
                "train_scene": scene["launches"][kernel], "serve_beta_s":
                serve_b["launches"][kernel], "serve_hier": serve_h["launches"][kernel],
                "eval_scene": eval_scene["launches"][kernel],
                "serve_view": serve_view["launches"][kernel]}

    f32 = times["float32"]
    k1t = train_t["field_fused"]
    k3t = trunk_t[f"k3_f32_{TRUNK_TIME_POINTS[1]}"]
    k6t = trunk_t["k6_bf16"]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "shape")
    op_keys = ("bound_3xtf32_ms", "bound_f32_fma_ms", "bound_bf16_ms")
    fwd_t = train_t["forward_times"]

    def bwd_line(key):  # f32 at the training shape; bf16, split and yardsticks beside
        f, b = train_t[f"{key}/float32"], train_t[f"{key}/bfloat16"]
        keys = ("ms", "row_ms", "reduce_ms", "bound_ms", "bound_by", "bound_f32_fma_ms",
                "library_ms_blocks", "parent_ms")
        return {**{k: f[k] for k in timed + keys if k in f}, "library_ms": None,
                "bf16": {k: b[k] for k in keys if k in b}}
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
                               + [trunk_t[f"k3_f32_{n}"]["max_abs_err"]
                                  for n in TRUNK_TIME_POINTS]),
            **{k: k3t[k] for k in timed + op_keys},
            "library_ms": None,
            "turns": {k: v for k, v in fwd_t.items() if k.startswith("trunk_fwd")},
            "at_65536": {k: trunk_t[f"k3_f32_{TRUNK_TIME_POINTS[0]}"][k] for k in timed},
            "bf16_at_k6_shape": {k: trunk_t["k3_bf16_k6_shape"][k]
                                 for k in timed + op_keys},
        },
        {
            "name": "trunk_fwd_interleaved", "route": "cuda",
            "source": "satnerf_torch/csrc/trunk_fwd.cu",
            "replaces": "tools/interleave_trunk_proto.py:64",
            "launches": beta_s["launches"]["trunk_fwd_interleaved"], "on_main_path": False,
            "max_abs_err": k6t["max_abs_err"], "bitwise_repeat": k6t["bitwise_repeat"],
            **{k: k6t[k] for k in timed + op_keys},
            "library_ms": None,
        },
    ]
    for entry in kernels:
        if entry["name"] in PER_STEP:
            entry["launches_by_path"] = by_path(entry["name"])
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
