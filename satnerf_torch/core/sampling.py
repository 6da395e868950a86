"""Ray sampling (port of ``satnerf_tpu/core/sampling.py``): stratified
coarse depths (``sample_rays``) and the hierarchical inverse-CDF samplers
(``sample_pdf``, ``sample_pdf_midpoint``).

Randomness is an explicit tensor of uniform [0, 1) draws (``noise``, ``u``)
instead of a JAX PRNG key, so the tests can hand both packages the same
numbers.
"""

from __future__ import annotations

import torch

from satnerf_torch.core.rays import ray_component


def sample_rays(
    rays: torch.Tensor,
    n_samples: int,
    noise: torch.Tensor | None = None,
    use_disp: bool = False,
    perturb: float = 1.0,
    given_z_vals: torch.Tensor | None = None,
):
    """Depths along each ray -> (xyz (N, S, 3), z_vals (N, S)).

    ``noise=None`` (or ``perturb <= 0``) gives the deterministic linspace
    ladder that eval and serving use; otherwise ``noise`` (N, S) jitters
    each sample inside its stratum.
    """
    rays_o = ray_component(rays, "origins")
    rays_d = ray_component(rays, "directions")
    near = ray_component(rays, "near")
    far = ray_component(rays, "far")

    if given_z_vals is not None:
        z_vals = given_z_vals
    else:
        z_steps = _unit_ladder(n_samples, rays)
        if not use_disp:
            z_vals = near * (1.0 - z_steps) + far * z_steps
        else:
            z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)

        if perturb > 0 and noise is not None:
            z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
            upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
            lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
            z_vals = lower + (upper - lower) * (perturb * noise.to(z_vals.dtype))

    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return xyz, z_vals


def _unit_ladder(n: int, like: torch.Tensor) -> torch.Tensor:
    """iota * f32(1/(n-1)): the values jnp.linspace(0, 1, n) gives, which
    torch.linspace misses by an ulp at about half of the rungs."""
    return torch.arange(n, dtype=like.dtype, device=like.device) * (1.0 / max(n - 1, 1))


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               u: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Hierarchical sampling: ``n_importance`` depths per ray drawn from the
    coarse-weight distribution by the inverse-CDF transform.

    Args:
        bins: (N, S+1) bin edges.
        weights: (N, S) coarse weights.
        u: (N, n_importance) uniform draws; ``None`` gives the deterministic
            0..1 ladder (the reference's ``det``).
    Returns:
        (N, n_importance) samples.
    """
    n_rays, n_bins = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, S+1)
    if u is None:
        u = _unit_ladder(n_importance, bins).expand(n_rays, n_importance)
    return _inverse_cdf_interp(bins, cdf, u.to(bins.dtype), n_bins, clamp_denom_below=eps)


def _inverse_cdf_interp(bins, cdf, u, n_bins: int, clamp_denom_below=None,
                        denom_eps: float = 0.0):
    """Locate each u in the per-ray cdf (the first index whose cdf exceeds
    it, ``searchsorted`` with ``right=True``) and interpolate linearly
    between the bin values around it.

    clamp_denom_below: replace denominators below this with 1 (sample_pdf's
        guard). denom_eps: added to every denominator (the midpoint
        variant's guard).
    """
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n_bins)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)
    denom = cdf_above - cdf_below + denom_eps
    if clamp_denom_below is not None:
        denom = torch.where(denom < clamp_denom_below, torch.ones_like(denom), denom)
    return bins_below + (u - cdf_below) / denom * (bins_above - bins_below)


def sample_pdf_midpoint(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
                        eps: float = 1e-8) -> torch.Tensor:
    """Deterministic inverse-CDF sampling at the midpoints of
    ``n_importance`` uniform intervals of [0, 1] (the reference's SDF-style
    sampler). ``weights`` (N, S) need not be normalised; ``bins`` (N, S+1).
    """
    n_rays, n_bins = weights.shape
    pdf = weights / torch.clamp(torch.sum(torch.abs(weights), dim=-1, keepdim=True),
                                min=eps)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    grid = _unit_ladder(n_importance + 1, bins)
    u = (0.5 * (grid[:-1] + grid[1:])).expand(n_rays, n_importance)
    return _inverse_cdf_interp(bins, cdf, u, n_bins, denom_eps=eps)
