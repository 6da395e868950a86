"""Fused alpha compositing + irradiance-weighted accumulation.

Port of ``satnerf_tpu/ops/pallas/composite.py`` (``composite_pallas`` ->
``_composite_kernel``). Per ray: alpha = 1 - exp(-delta * relu(sigma)) with
delta_last = 1e10, the exclusive transmittance product of
(1 - alpha + 1e-10), weights, depth = sum w z and
rgb = clip(sum w * albedo * (sun + (1 - sun) * sky), 0, 1).

``composite`` launches ``csrc/composite.cu`` (one warp per ray) for CUDA
tensors and runs :func:`composite_reference` for CPU tensors. Under autograd
CUDA tensors go through :class:`Composite`, whose backward is the
hand-written ``composite_backward`` kernel of the same source (the JAX
renderer differentiates XLA code here, so the TPU has no backward kernel);
its plain version is autograd through :func:`composite_reference`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from satnerf_torch.core.compositing import convert_sigmas
from satnerf_torch.ops._build import check_launch, load_library

LAUNCHES = 0  # forward kernel launches made by composite (CUDA tensors only)
BWD_LAUNCHES = 0  # backward kernel launches made by Composite (CUDA only)
PLAIN_CALLS = 0  # composite_reference calls
MAX_SAMPLES = 1024  # the kernel walks a ray in 32-sample steps, up to this


def composite_reference(sigmas, z_vals, albedo, sun, sky):
    """sigmas, z_vals, sun (B, S); albedo (B, S, 3); sky (B, 3) ->
    weights (B, S), transparency (B, S), depth (B,), rgb (B, 3)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    weights, depth, transparency, _ = convert_sigmas(sigmas, z_vals)
    irr = sun[..., None] + (1.0 - sun[..., None]) * sky[:, None, :]
    rgb = torch.clamp(torch.sum(weights[..., None] * albedo * irr, dim=-2),
                      0.0, 1.0)
    return weights, transparency, depth, rgb


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(sigmas, z_vals, albedo, sun, sky):
    """Shapes (B, S) and S of a CUDA call, or raise."""
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
    return b, s


def _forward_cuda(sigmas, z_vals, albedo, sun, sky):
    global LAUNCHES
    b, s = _check(sigmas, z_vals, albedo, sun, sky)
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    check_launch(lib, lib.composite_forward(
        _ptr(sigmas), _ptr(z_vals), _ptr(albedo), _ptr(sun), _ptr(sky),
        _ptr(weights), _ptr(transparency), _ptr(depth), _ptr(rgb),
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_void_p(stream),
    ), "composite")
    LAUNCHES += 1
    return weights, transparency, depth, rgb


def composite_backward(inputs, weights, transparency, g_w, g_t, g_depth, g_rgb):
    """The backward kernel: ``inputs`` = (sigmas, z_vals, albedo, sun, sky)
    and the forward's weights and transparency, with the gradients of the
    four outputs -> (g_sigmas, g_albedo, g_sun, g_sky). CUDA only."""
    global BWD_LAUNCHES
    sigmas, z_vals, albedo, sun, sky = inputs
    b, s = _check(*inputs)
    dev = sigmas.device
    grads = [g.to(torch.float32).contiguous() for g in (g_w, g_t, g_depth, g_rgb)]
    for g, shape in zip(grads, ((b, s), (b, s), (b,), (b, 3))):
        if tuple(g.shape) != shape or g.device != dev:
            raise ValueError(f"composite_backward: gradient {tuple(g.shape)} on "
                             f"{g.device}, expected {shape}")
    g_sigmas = torch.empty((b, s), dtype=torch.float32, device=dev)
    g_albedo = torch.empty((b, s, 3), dtype=torch.float32, device=dev)
    g_sun = torch.empty((b, s), dtype=torch.float32, device=dev)
    g_sky = torch.empty((b, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return g_sigmas, g_albedo, g_sun, g_sky
    lib = load_library("composite")
    stream = torch.cuda.current_stream(dev).cuda_stream
    check_launch(lib, lib.composite_backward(
        *(_ptr(t) for t in (sigmas, z_vals, albedo, sun, sky, weights, transparency)),
        *(_ptr(g) for g in grads),
        _ptr(g_sigmas), _ptr(g_albedo), _ptr(g_sun), _ptr(g_sky),
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_void_p(stream),
    ), "composite_backward")
    BWD_LAUNCHES += 1
    return g_sigmas, g_albedo, g_sun, g_sky


class Composite(torch.autograd.Function):
    """The compositing kernel with its backward kernel (CUDA tensors).

    Gradients reach sigmas, albedo, sun and sky; z_vals gets none (a
    backward asked for one raises). Only first derivatives exist."""

    @staticmethod
    def forward(ctx, sigmas, z_vals, albedo, sun, sky):
        inputs = tuple(t.contiguous() for t in (sigmas, z_vals, albedo, sun, sky))
        weights, transparency, depth, rgb = _forward_cuda(*inputs)
        ctx.save_for_backward(*inputs, weights, transparency)
        return weights, transparency, depth, rgb

    @staticmethod
    @once_differentiable
    def backward(ctx, g_w, g_t, g_depth, g_rgb):
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("Composite: no gradient for z_vals")
        *inputs, weights, transparency = ctx.saved_tensors
        g_sigmas, g_albedo, g_sun, g_sky = composite_backward(
            inputs, weights, transparency, g_w, g_t, g_depth, g_rgb)
        return g_sigmas, None, g_albedo, g_sun, g_sky


def composite(sigmas, z_vals, albedo, sun, sky):
    """Fused compositing tail; same contract as :func:`composite_reference`.

    CPU tensors run the plain version (autograd differentiates it); CUDA
    tensors launch the kernel (counted in ``LAUNCHES``), through
    :class:`Composite` when grad mode is on and an input requires grad, or
    raise.
    """
    if sigmas.device.type == "cpu":
        return composite_reference(sigmas, z_vals, albedo, sun, sky)
    inputs = (sigmas, z_vals, albedo, sun, sky)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return Composite.apply(*inputs)
    return _forward_cuda(*inputs)
