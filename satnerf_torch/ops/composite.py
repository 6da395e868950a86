"""Fused alpha compositing + irradiance-weighted accumulation.

Port of ``satnerf_tpu/ops/pallas/composite.py`` (``composite_pallas`` ->
``_composite_kernel``). Per ray: alpha = 1 - exp(-delta * relu(sigma)) with
delta_last = 1e10, the exclusive transmittance product of
(1 - alpha + 1e-10), weights, depth = sum w z and
rgb = clip(sum w * albedo * (sun + (1 - sun) * sky), 0, 1).

``composite`` launches ``csrc/composite.cu`` (one warp per ray) for CUDA
tensors and runs :func:`composite_reference` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from satnerf_torch.core.compositing import convert_sigmas
from satnerf_torch.ops._build import load_library

LAUNCHES = 0  # kernel launches made by composite (CUDA tensors only)
MAX_SAMPLES = 1024  # the kernel walks a ray in 32-sample steps, up to this


def composite_reference(sigmas, z_vals, albedo, sun, sky):
    """sigmas, z_vals, sun (B, S); albedo (B, S, 3); sky (B, 3) ->
    weights (B, S), transparency (B, S), depth (B,), rgb (B, 3)."""
    weights, depth, transparency, _ = convert_sigmas(sigmas, z_vals)
    irr = sun[..., None] + (1.0 - sun[..., None]) * sky[:, None, :]
    rgb = torch.clamp(torch.sum(weights[..., None] * albedo * irr, dim=-2),
                      0.0, 1.0)
    return weights, transparency, depth, rgb


def composite(sigmas, z_vals, albedo, sun, sky):
    """Fused compositing tail; same contract as :func:`composite_reference`.

    CUDA tensors launch the kernel (counted in ``LAUNCHES``) or raise.
    """
    global LAUNCHES
    if sigmas.device.type == "cpu":
        return composite_reference(sigmas, z_vals, albedo, sun, sky)
    if sigmas.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {sigmas.device}")
    b, s = sigmas.shape
    want = {
        "sigmas": (sigmas, (b, s)), "z_vals": (z_vals, (b, s)),
        "albedo": (albedo, (b, s, 3)), "sun": (sun, (b, s)), "sky": (sky, (b, 3)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"composite: {name} is {tuple(t.shape)} {t.dtype}, "
                f"expected {shape} float32"
            )
        if t.device != sigmas.device:
            raise ValueError(f"composite: {name} is on {t.device}")
    if s < 1 or s > MAX_SAMPLES:
        raise ValueError(f"composite: S={s} outside 1..{MAX_SAMPLES}")
    sigmas, z_vals, albedo, sun, sky = (
        t.contiguous() for t in (sigmas, z_vals, albedo, sun, sky)
    )
    dev = sigmas.device
    weights = torch.empty((b, s), dtype=torch.float32, device=dev)
    transparency = torch.empty((b, s), dtype=torch.float32, device=dev)
    depth = torch.empty((b,), dtype=torch.float32, device=dev)
    rgb = torch.empty((b, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return weights, transparency, depth, rgb

    lib = load_library("composite")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.composite_forward(
        ptr(sigmas), ptr(z_vals), ptr(albedo), ptr(sun), ptr(sky),
        ptr(weights), ptr(transparency), ptr(depth), ptr(rgb),
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"composite kernel launch failed: cudaError {err} "
            f"({lib.satnerf_cuda_error_string(err).decode()})"
        )
    LAUNCHES += 1
    return weights, transparency, depth, rgb
