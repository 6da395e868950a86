"""Ray sampling (port of ``sample_rays`` in ``satnerf_tpu/core/sampling.py``).

Randomness is an explicit ``noise`` tensor of uniform [0, 1) draws instead
of a JAX PRNG key, so the tests can hand both packages the same numbers.
The hierarchical inverse-CDF sampler is not ported yet.
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
        # iota * f32(1/(S-1)): the values jnp.linspace(0, 1, S) gives, which
        # torch.linspace misses by an ulp at about half of the rungs
        z_steps = torch.arange(n_samples, dtype=rays.dtype, device=rays.device)
        z_steps = z_steps * (1.0 / max(n_samples - 1, 1))
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
