"""Volume-rendering alpha compositing (port of ``satnerf_tpu/core/compositing.py``).

delta_inf = 1e10, alpha = 1 - exp(-delta * relu(sigma)), transmittance =
exclusive cumprod of (1 - alpha + 1e-10), weights = alpha * T,
depth = sum(w * z).
"""

from __future__ import annotations

import torch


def convert_sigmas(sigmas: torch.Tensor, z_vals: torch.Tensor):
    """sigma (N, S), z (N, S) -> (weights, depth (N,), transparency, alphas)."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    # shaped from z_vals: at S = 1 deltas[:, :1] is empty (the JAX package's
    # convert_sigmas returns (N, 0) weights there)
    delta_inf = torch.full_like(z_vals[:, :1], 1e10)
    deltas = torch.cat([deltas, delta_inf], dim=-1)

    alphas = 1.0 - torch.exp(-deltas * torch.clamp(sigmas, min=0.0))
    shifted = torch.cat(
        [torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    transparency = torch.cumprod(shifted, dim=-1)[:, :-1]
    weights = alphas * transparency
    depth = torch.sum(weights * z_vals, dim=-1)
    return weights, depth, transparency, alphas


def composite_scalar(weights: torch.Tensor, values: torch.Tensor):
    """Accumulate per-sample values (N, S, C) with weights (N, S) -> (N, C)."""
    return torch.sum(weights[..., None] * values, dim=-2)
