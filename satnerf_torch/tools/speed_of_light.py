"""Speed-of-light attribution of the flagship training step on one card
(counterpart of the JAX package's ``tools/speed_of_light.py``).

Times, each with CUDA events (the best of three after a warm call):

  gemm             the bare trunk GEMM chain at the production shapes and
                   dtype (8 layers x 512, the skip concat at 4) over the
                   step's point count, solar-correction points included:
                   the tensor-core floor
  gemm+plain_sin   the same chain with the polynomial sine's plain version
                   (``ops/fastmath.py``) after every layer, in eager
                   PyTorch: each sine is a score of unfused elementwise
                   passes over the layer's f32 output in memory. It times
                   that plain chain and does not stand for the kernel path,
                   where K1 applies the sine in registers between its
                   products (the JAX tool's ``gemm+sin``, whose sine XLA
                   fuses)
  fwd              the full render forward (``render_rays``, no autograd)
  step             the full training step (every loss term and the Adam
                   update)

and derives achieved TFLOP/s and their share of the peak of the engine
that runs the products. The chain is plain ``torch.matmul``: in the JAX
tool it is an XLA product outside any Pallas kernel. The forward and the
step run the kernels.

    python -m satnerf_torch.tools.speed_of_light [--batch 8192] [--samples 64]
        [--dtype bfloat16] [--scan 30] [--peak-tflops T] [--sc-stride 1]
        [--sin poly] [--feat 512] [--layers 8]

``--peak-tflops`` is the peak of the chain's engine and defaults to one
H100's published dense peak for the dtype (NVIDIA's data sheet, SXM, at
the 700 W limit): 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor
cores (TF32 is turned off here, ``device.disable_tf32``). The step row's
share is of the engine its kernels run: in bf16 the same tensor cores
(``--peak-tflops`` applies), in f32 the TF32 tensor cores three times per
product (3xTF32: 495 / 3 TFLOP/s, whatever ``--peak-tflops`` says). Each
row carries the peak it was divided by. The card's name and power limit
stand in the printed config. Without a card it raises.
"""

from __future__ import annotations

import argparse
import json

import torch

PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}
TF32_PEAK_TFLOPS = 495.0  # the kernels' f32 products run as three TF32 products
XYZ_IN = 63  # posenc (10 frequencies) of xyz and xyz itself (rs_semantic mapping)
SKIPS = (4,)
TRIALS = 3


def point_count(batch: int, samples: int, sc_stride: int) -> int:
    """Field points of one step: the main half and the solar-correction half,
    ceil(samples / sc_stride) rungs a ray (the renderer anchors the strided
    rungs at the last sample, so each ray keeps that many)."""
    return batch * samples + batch * (-(-samples // max(sc_stride, 1)))


def chain_weights(layers: int, feat: int, dtype, device) -> list:
    """(fan_in, feat) weights of the trunk's layers, N(0, 0.02^2) from seed
    0, the encoding concatenated again at the skips."""
    g = torch.Generator(device=device).manual_seed(0)
    ws, fan_in = [], XYZ_IN
    for i in range(layers):
        if i in SKIPS:
            fan_in += XYZ_IN
        ws.append((torch.randn((fan_in, feat), generator=g, device=device) * 0.02).to(dtype))
        fan_in = feat
    return ws


def gemm_flops(n_points: int, ws: list) -> int:
    return 2 * n_points * sum(int(w.shape[0]) * int(w.shape[1]) for w in ws)


def chain(x0: torch.Tensor, ws: list, sin_fn=None, passes: int = 1) -> torch.Tensor:
    """``passes`` passes of the trunk's products (each followed by
    ``sin_fn`` when given); each pass's output is folded back to the input
    width as the next pass's input -> every pass's output sum."""
    x, sums = x0, []
    for _ in range(passes):
        h = x
        for i, w in enumerate(ws):
            if i in SKIPS:
                h = torch.cat([h, x], dim=-1)
            h = h @ w
            if sin_fn is not None:
                h = sin_fn(h)
        sums.append(h.sum())
        x = h[:, :XYZ_IN].to(x.dtype)
    return torch.stack(sums)


def _best_ms(fn) -> float:
    """Best-of-TRIALS CUDA-event ms of ``fn()`` after one warm call."""
    from satnerf_torch.bench import timed_window

    timed_window(fn, 1)
    return min(timed_window(fn, 1)[0] for _ in range(TRIALS))


def main(argv=None) -> dict:
    """Measure, print the rows and return them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(PEAK_TFLOPS))
    ap.add_argument("--scan", type=int, default=30)
    ap.add_argument("--feat", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the peak of the chain's engine for --dtype (default: one "
                         "H100's published dense peak, 989 bf16, 67 f32 without TF32)")
    ap.add_argument("--sin", default="poly", choices=["poly", "poly5", "poly7f"])
    ap.add_argument("--sc-stride", type=int, default=1,
                    help="solar-correction quadrature stride (2 = the JAX package's "
                         "gate-passed production setting); scales the point count")
    args = ap.parse_args(argv)

    from satnerf_torch.bench import synthetic_batch
    from satnerf_torch.configs import resolve_trunk_impl
    from satnerf_torch.device import card_line, disable_tf32, resolve_device
    from satnerf_torch.models.field import FieldConfig
    from satnerf_torch.ops.fastmath import SINE_ENGINES
    from satnerf_torch.render.renderer import RenderConfig, render_rays
    from satnerf_torch.train.state import create_train_state, init_params
    from satnerf_torch.train.step import StepConfig, build_train_step

    dev = resolve_device(None)
    disable_tf32()
    peak = PEAK_TFLOPS[args.dtype] if args.peak_tflops is None else args.peak_tflops
    dt = getattr(torch, args.dtype)
    n_points = point_count(args.batch, args.samples, args.sc_stride)
    ws = chain_weights(args.layers, args.feat, dt, dev)
    x0 = torch.randn((n_points, XYZ_IN), generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev).to(dt)
    flops = gemm_flops(n_points, ws)
    scan = args.scan

    rows = []
    for name, sin_fn in (("gemm", None), ("gemm+plain_sin", SINE_ENGINES[args.sin])):
        s = _best_ms(lambda f=sin_fn: chain(x0, ws, f, scan)) * 1e-3 / scan
        tflops = flops / s / 1e12
        rows.append({"what": name, "ms": s * 1e3, "achieved_tflops": tflops,
                     "peak_tflops": peak, "mfu_vs_peak": tflops / peak})
    del x0, ws

    # the full forward and training step at the same configuration (the bench's)
    fcfg = FieldConfig(variant="rs_semantic", mapping=True, siren=True, n_classes=5,
                       sin_impl=args.sin, trunk_impl=resolve_trunk_impl("xla", dev))
    rcfg = RenderConfig(field=fcfg, n_samples=args.samples, solar_correction=True,
                        compute_dtype=args.dtype, sc_stride=args.sc_stride)
    scfg = StepConfig(render=rcfg, steps_per_epoch=1000, sc_lambda=0.05, first_beta_epoch=0,
                      depth=True, semantic=True, car_index=4, use_car_reg_loss=True,
                      car_reg_loss_start=0)
    params = init_params(torch.Generator().manual_seed(0), fcfg, t_vocab=50, device=dev)
    batch = synthetic_batch(args.batch, depth=min(1024, args.batch), device=dev)

    gen_f = torch.Generator(device=dev).manual_seed(2)

    def fwd_many():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(scan):
            acc += render_rays(params, rcfg, batch["rays"], batch["extras"],
                               generator=gen_f)["rgb"].float().sum()
        return acc

    with torch.inference_mode():
        fwd_s = _best_ms(fwd_many) * 1e-3 / scan
    rows.append({"what": "fwd (render_rays)", "ms": fwd_s * 1e3})

    state = create_train_state(params, 5e-4, steps_per_epoch=1000)
    step = build_train_step(scfg)
    gen_s = torch.Generator(device=dev).manual_seed(3)
    losses = []

    def step_many():
        for _ in range(scan):
            loss = step(state, batch, gen_s)[1]["loss"]
        losses.append(loss)

    step_s = _best_ms(step_many) * 1e-3 / scan
    if not all(torch.isfinite(v).item() for v in losses):
        raise RuntimeError("speed_of_light: non-finite training loss")
    # forward + backward + update ~ 3x the forward GEMMs (fwd, dL/dx, dL/dW)
    step_tflops = 3 * flops / step_s / 1e12
    step_peak = peak if args.dtype == "bfloat16" else TF32_PEAK_TFLOPS / 3
    rows.append({"what": "train step (fused)", "ms": step_s * 1e3,
                 "achieved_tflops_3x_gemm": step_tflops, "peak_tflops": step_peak,
                 "mfu_vs_peak": step_tflops / step_peak})

    out = {
        "config": {"batch": args.batch, "samples": args.samples, "dtype": args.dtype,
                   "sc_stride": args.sc_stride, "points_per_step": n_points,
                   "gemm_flops_per_step": flops, "card": card_line()},
        "rows": rows,
    }
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
