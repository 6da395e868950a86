#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (satnerf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``satnerf_torch/csrc`` and runs, printing one
JSON line per phase:

1. device and toolchain;
2. the kernel build (one nvcc per source, in parallel);
3. the sine engines of ``csrc/sine.cuh`` against ``ops/fastmath.py``;
4. the fused field kernel against its plain PyTorch version at the
   flagship width (rs_semantic 8x512), f32 and bf16, both head variants;
5. the compositing kernel against its plain version;
6. the serving path: a ``RenderService`` on seeded weights answers three
   128x128 requests through both kernels (launch counters prove it), its
   first 1,024 rays are held against the plain path on the CPU, and one
   solar-correction render runs the sigma+sun-only field variant;
7. CUDA-event times of each kernel and its plain version at the serve
   shapes, beside the least time the card could take; the field kernel is
   held against its plain version at that shape too.

Then the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero. Without a GPU (or outside the repository) it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PIPELINE_TOML = os.path.join(REPO, "configs", "pipelines", "rs_semantic.toml")

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
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

N_FIELD_CHECK = 65_537  # ragged against the 32-row tile
SERVE_H = SERVE_W = 128
N_REQUESTS = 3
CHUNK = 16_384


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


def main() -> int:
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
        from satnerf_torch.models.field import Field, fused_field_spec
        from satnerf_torch.ops import _build, composite as comp_mod
        from satnerf_torch.ops import field_fused as ff
        from satnerf_torch.ops.fastmath import SINE_ENGINES
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

    # ---- 3. sine engines ------------------------------------------------------
    import ctypes

    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.cat([torch.linspace(-1e3, 1e3, 1 << 20),
                   (torch.rand(1 << 20, generator=g) * 2 - 1) * 1e3]).to(dev)
    lib = _build.load_library("sine_check")
    sine_err = {}
    for mode, name in enumerate(ff.SIN_MODES):
        y = torch.empty_like(x)
        err = lib.sine_eval(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                            x.numel(), mode,
                            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        check(err == 0, f"sine_eval launch error {err}")
        torch.cuda.synchronize()
        sine_err[name] = float((y - SINE_ENGINES[name](x)).abs().max())
        check(sine_err[name] <= TOL_SINE, f"sine {name} err {sine_err[name]}")
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
    enc, sun_d, t_emb = field_inputs(N_FIELD_CHECK, 1)
    field_err = {}
    with torch.inference_mode():
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            packed = field.packed(dt)
            for heads_on in (True, False):
                sp = replace(spec, heads_on=heads_on)
                xk = ff.pack_x(sp, enc, dt)
                aux = ff.pack_aux(sp, sun_d, t_emb, None, dt)
                out_k = ff.fused_field(sp, xk, aux, packed)
                torch.cuda.synchronize()
                out_p = ff.fused_field_reference(sp, xk, aux, packed)
                check(bool(torch.isfinite(out_k).all()), f"field {dname} non-finite")
                errs = {k: float((out_k[:, c:c + w] - out_p[:, c:c + w]).abs().max())
                        for k, (c, w) in groups.items()}
                key = f"{dname}/heads_{'on' if heads_on else 'off'}"
                field_err[key] = errs
                worst = max(errs.values())
                check(worst <= TOL_FIELD[dname], f"field {key} err {errs}")
    emit({"phase": "field_fused_check", "n": N_FIELD_CHECK, "layers": spec.layers,
          "feat": spec.feat, "c_in": spec.c_in, "fl": spec.fl,
          "n_classes": spec.n_classes, "max_abs_err": field_err, "tol": TOL_FIELD})

    # ---- 5. composite vs plain -------------------------------------------------
    def comp_inputs(b: int, s: int, seed: int):
        gc = torch.Generator().manual_seed(seed)
        sig = torch.rand(b, s, generator=gc) * 6 - 1  # some negative densities
        z = torch.sort(torch.rand(b, s, generator=gc) * 2, dim=1).values
        alb = torch.rand(b, s, 3, generator=gc)
        sun = torch.rand(b, s, generator=gc)
        sky = torch.rand(b, 3, generator=gc)
        return [t.to(dev) for t in (sig, z, alb, sun, sky)]

    comp_err = {}
    names = ("weights", "transparency", "depth", "rgb")
    for b, s in ((CHUNK, rcfg.n_samples), (1001, rcfg.n_samples), (77, 37)):
        args = comp_inputs(b, s, b + s)
        outs_k = comp_mod.composite(*args)
        torch.cuda.synchronize()
        outs_p = comp_mod.composite_reference(*args)
        errs = {n: float((a - r).abs().max()) for n, a, r in zip(names, outs_k, outs_p)}
        comp_err[f"{b}x{s}"] = errs
        for n in names:
            check(errs[n] <= TOL_COMPOSITE[n], f"composite {b}x{s} {n} {errs[n]}")
    emit({"phase": "composite_check", "max_abs_err": comp_err, "tol": TOL_COMPOSITE})

    # ---- 6. serve ----------------------------------------------------------------
    svc = RenderService({"field": field, "t": table}, rcfg, chunk=CHUNK, device=dev)
    n_rays = SERVE_H * SERVE_W
    requests = [synthetic_rays(n_rays, 100 + i, vocab) for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    ff.LAUNCHES = 0
    comp_mod.LAUNCHES = 0
    results, req_ms = [], []
    for rays, extras in requests:
        t0 = time.monotonic()
        results.append(svc.render_rays(rays, extras, SERVE_H, SERVE_W))
        req_ms.append((time.monotonic() - t0) * 1e3)
    launches = {"field_fused": ff.LAUNCHES, "composite": comp_mod.LAUNCHES}
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
          "chunk": CHUNK, "launches": launches, "request_ms": req_ms,
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
            peak = PEAK_F32_FLOPS if dt == torch.float32 else PEAK_BF16_FLOPS
            ops_ms = flops / peak * 1e3
            bytes_ms = (io_bytes + weight_bytes) / PEAK_HBM_BYTES * 1e3
            times[dname] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "max_abs_err": err, "flops": flops, "bytes": io_bytes + weight_bytes,
                "achieved_tflops": flops / (k_ms * 1e-3) / 1e12,
            }
            del xk, aux
    emit({"phase": "field_fused_time", "points": n_pts,
          "mac_per_point": spec.mac_per_point(),
          "sines_per_point": spec.sines_per_point(), "times": times})

    cargs = comp_inputs(CHUNK, rcfg.n_samples, 7)
    c_ms = cuda_ms(lambda: comp_mod.composite(*cargs), reps=50, warmup=3)
    cp_ms = cuda_ms(lambda: comp_mod.composite_reference(*cargs), reps=50, warmup=3)
    b, s = CHUNK, rcfg.n_samples
    c_bytes = 4 * (b * s * (1 + 1 + 3 + 1) + b * 3) + 4 * (2 * b * s + b + 3 * b)
    c_flops = 25.0 * b * s  # per sample: alpha, scan, weight, depth, 3 irradiance terms
    c_bytes_ms = c_bytes / PEAK_HBM_BYTES * 1e3
    c_ops_ms = c_flops / PEAK_F32_FLOPS * 1e3
    emit({"phase": "composite_time", "shape": [b, s], "ms": c_ms, "plain_ms": cp_ms,
          "bytes": c_bytes, "bound_ms": max(c_bytes_ms, c_ops_ms)})

    f32 = times["float32"]
    kernels = [
        {
            "name": "field_fused", "route": "cuda",
            "source": "satnerf_torch/csrc/field_fused.cu",
            "replaces": "satnerf_tpu/ops/pallas/field_fused.py:361",
            "launches": launches["field_fused"],
            "max_abs_err": max([f32["max_abs_err"]]
                               + [max(e.values()) for k, e in field_err.items()
                                  if k.startswith("float32")]),
            "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
            "bf16": {k: times["bfloat16"][k]
                     for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "launches_per_request": launches["field_fused"] / N_REQUESTS,
        },
        {
            "name": "composite", "route": "cuda",
            "source": "satnerf_torch/csrc/composite.cu",
            "replaces": "satnerf_tpu/ops/pallas/composite.py:76",
            "launches": launches["composite"],
            "max_abs_err": max(max(e.values()) for e in comp_err.values()),
            "ms": c_ms, "plain_ms": cp_ms, "bound_ms": max(c_bytes_ms, c_ops_ms),
            "bound_by": "bytes" if c_bytes_ms >= c_ops_ms else "operations",
            "library_ms": None,
            "launches_per_request": launches["composite"] / N_REQUESTS,
        },
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
