"""Fused alpha compositing + irradiance-weighted accumulation.

Port of ``satnerf_tpu/ops/pallas/composite.py`` (``composite_pallas`` ->
``_composite_kernel``). Per ray: alpha = 1 - exp(-delta * relu(sigma)) with
delta_last = 1e10, the exclusive transmittance product of
(1 - alpha + 1e-10), weights, depth = sum w z and
rgb = clip(sum w * albedo * (sun + (1 - sun) * sky), 0, 1).

``composite`` launches ``csrc/composite.cu`` (one warp per ray, each lane a
run of consecutive samples) for CUDA tensors and runs
:func:`composite_reference` for CPU tensors. Under autograd CUDA tensors go
through :class:`Composite`: its forward also writes the pre-clip rgb, and its
backward is the hand-written ``composite_backward`` kernel of the same
source (the JAX renderer differentiates XLA code here, so the TPU has no
backward kernel); its plain version is autograd through
:func:`composite_reference`.

The kernels take ``sun`` and ``sky`` as row views (any row stride, unit
element stride), so the renderer's ``sun_v[..., 0]`` and ``sky[:, 0, :]``
pass without a copy; each call makes one output allocation, cut into views.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from satnerf_torch.core.compositing import convert_sigmas
from satnerf_torch.ops._build import check_launch, load_library

LAUNCHES = 0  # forward kernel launches made by composite (CUDA tensors only)
BWD_LAUNCHES = 0  # backward kernel launches made by Composite (CUDA only)
PLAIN_CALLS = 0  # composite_reference calls
MAX_SAMPLES = 1024  # the kernels walk a ray in segments of lane runs, up to this
_F32 = torch.float32
_FNS = None  # (library, forward, backward) of csrc/composite.cu, looked up once
# the current stream's handle as an int, without a Stream object per call
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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


def _fns():
    global _FNS
    if _FNS is None:
        lib = load_library("composite")
        _FNS = (lib, lib.composite_forward, lib.composite_backward)
    return _FNS


def _rows(t: torch.Tensor) -> tuple:
    """(t, row stride): a view whose elements are unit-strided passes as it is."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        t = t.contiguous()
    return t, t.stride(0)


def _check(sigmas, z_vals, albedo, sun, sky):
    """Shapes (B, S) and S of a CUDA call, or raise."""
    if sigmas.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {sigmas.device}")
    b, s = sigmas.shape
    for name, t, shape in (("sigmas", sigmas, (b, s)), ("z_vals", z_vals, (b, s)),
                           ("albedo", albedo, (b, s, 3)), ("sun", sun, (b, s)),
                           ("sky", sky, (b, 3))):
        if t.shape != shape or t.dtype != _F32:
            raise ValueError(f"composite: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} float32")
        if t.device != sigmas.device:
            raise ValueError(f"composite: {name} is on {t.device}")
    if s < 1 or s > MAX_SAMPLES:
        raise ValueError(f"composite: S={s} outside 1..{MAX_SAMPLES}")
    return b, s


def _stream(dev) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev.index if dev.index is not None else torch.cuda.current_device())
    return torch.cuda.current_stream(dev).cuda_stream


def _forward_cuda(sigmas, z_vals, albedo, sun, sky, resid: bool = False):
    """(weights, transparency, depth, rgb, pre-clip rgb or None) from one
    launch; ``resid`` asks for the pre-clip rgb (B, 3) the backward reads."""
    global LAUNCHES
    b, s = _check(sigmas, z_vals, albedo, sun, sky)
    sigmas, z_vals, albedo = sigmas.contiguous(), z_vals.contiguous(), albedo.contiguous()
    (sun, sun_rs), (sky, sky_rs) = _rows(sun), _rows(sky)
    dev = sigmas.device
    n = b * s
    # one allocation, cut into the outputs back to back
    buf = torch.empty(2 * n + (7 if resid else 4) * b, dtype=_F32, device=dev)
    weights, transparency = buf.as_strided((b, s), (s, 1)), buf.as_strided((b, s), (s, 1), n)
    depth, rgb = buf.as_strided((b,), (1,), 2 * n), buf.as_strided((b, 3), (3, 1), 2 * n + b)
    pre = buf.as_strided((b, 3), (3, 1), 2 * n + 4 * b) if resid else None
    if b:
        lib, fwd, _ = _fns()
        p = buf.data_ptr()
        check_launch(lib, fwd(
            sigmas.data_ptr(), z_vals.data_ptr(), albedo.data_ptr(), sun.data_ptr(), sun_rs,
            sky.data_ptr(), sky_rs, p, p + 4 * n, p + 8 * n, p + 8 * n + 4 * b,
            p + 8 * n + 16 * b if resid else None, b, s, _stream(dev),
        ), "composite")
        LAUNCHES += 1
    return weights, transparency, depth, rgb, pre


def composite_backward(inputs, transparency, rgb_pre, g_w, g_t, g_depth, g_rgb):
    """The backward kernel: ``inputs`` = (sigmas, z_vals, albedo, sun, sky),
    the forward's transparency and pre-clip rgb, and the gradients of the four
    outputs (None for an output that got none) -> (g_sigmas, g_albedo, g_sun,
    g_sky). CUDA only."""
    global BWD_LAUNCHES
    b, s = _check(*inputs)
    sigmas, z_vals, albedo, sun, sky = inputs
    sigmas, z_vals, albedo = sigmas.contiguous(), z_vals.contiguous(), albedo.contiguous()
    (sun, sun_rs), (sky, sky_rs) = _rows(sun), _rows(sky)
    dev = sigmas.device
    ptrs = []
    for name, t, shape in (("transparency", transparency, (b, s)), ("rgb_pre", rgb_pre, (b, 3)),
                           ("g_w", g_w, (b, s)), ("g_t", g_t, (b, s)),
                           ("g_depth", g_depth, (b,)), ("g_rgb", g_rgb, (b, 3))):
        if t is None and name.startswith("g_"):
            ptrs.append(None)
            continue
        t = t.to(_F32).contiguous()
        if t.shape != shape or t.device != dev:
            raise ValueError(f"composite_backward: {name} {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {dev}")
        ptrs.append(t)
    n = b * s
    # one allocation, cut into the gradients back to back
    buf = torch.empty(5 * n + 3 * b, dtype=_F32, device=dev)
    g_sigmas, g_albedo = buf.as_strided((b, s), (s, 1)), buf.as_strided((b, s, 3), (3 * s, 3, 1), n)
    g_sun, g_sky = buf.as_strided((b, s), (s, 1), 4 * n), buf.as_strided((b, 3), (3, 1), 5 * n)
    if b:
        lib, _, bwd = _fns()
        p = buf.data_ptr()
        check_launch(lib, bwd(
            sigmas.data_ptr(), z_vals.data_ptr(), albedo.data_ptr(), sun.data_ptr(), sun_rs,
            sky.data_ptr(), sky_rs, *(None if t is None else t.data_ptr() for t in ptrs),
            p, p + 4 * n, p + 16 * n, p + 20 * n, b, s, _stream(dev),
        ), "composite_backward")
        BWD_LAUNCHES += 1
    return g_sigmas, g_albedo, g_sun, g_sky


class Composite(torch.autograd.Function):
    """The compositing kernel with its backward kernel (CUDA tensors).

    Gradients reach sigmas, albedo, sun and sky; z_vals gets none (a
    backward asked for one raises). An output that gets no gradient passes
    none to the kernel (no zeros are made for it). Only first derivatives
    exist."""

    @staticmethod
    def forward(ctx, sigmas, z_vals, albedo, sun, sky):
        weights, transparency, depth, rgb, pre = _forward_cuda(
            sigmas, z_vals, albedo, sun, sky, resid=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(sigmas, z_vals, albedo, sun, sky, transparency, pre)
        return weights, transparency, depth, rgb

    @staticmethod
    @once_differentiable
    def backward(ctx, g_w, g_t, g_depth, g_rgb):
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("Composite: no gradient for z_vals")
        *inputs, transparency, pre = ctx.saved_tensors
        g_sigmas, g_albedo, g_sun, g_sky = composite_backward(
            inputs, transparency, pre, g_w, g_t, g_depth, g_rgb)
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
    return _forward_cuda(*inputs)[:4]
