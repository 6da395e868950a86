"""Volume renderer: sampling + field + compositing (port of
``satnerf_tpu/render/renderer.py``, forward only).

The solar-correction pass does not issue a second field call: its sample
points (the z ladder marched along the sun direction) are concatenated onto
the main batch, and the field prunes its heads there (``n_full``).

Per-ray outputs: irradiance = sun_v + (1 - sun_v) * sky,
rgb = clamp(sum w * albedo * irradiance); semantic logits composited with
the weights, then argmax. For variants with a sun head the main half's
weights, transparency, depth and rgb come from the fused compositing
kernel (``ops/composite.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from satnerf_torch.core.compositing import composite_scalar, convert_sigmas
from satnerf_torch.core.rays import extras_component, ray_component
from satnerf_torch.core.sampling import sample_rays
from satnerf_torch.device import resolve_device
from satnerf_torch.models.embeddings import embedding_lookup
from satnerf_torch.models.field import FieldConfig, field_forward
from satnerf_torch.ops.composite import composite

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering flags (same fields as the reference)."""

    field: FieldConfig
    n_samples: int = 64
    solar_correction: bool = True
    perturb: float = 1.0
    n_importance: int = 0  # hierarchical pass: a later slice
    use_fine_network: bool = False
    sc_stride: int = 1
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # training-memory knobs; a forward-only render ignores them
    remat: bool = False
    remat_chunks: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def _per_point(x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, C) per-ray -> (B*S, C) per-point."""
    b, c = x.shape
    return x[:, None, :].expand(b, n_samples, c).reshape(-1, c)


def render_rays(
    params: dict,
    rcfg: RenderConfig,
    rays: torch.Tensor,
    extras: torch.Tensor,
    noise: torch.Tensor | None = None,
    given_z_vals: torch.Tensor | None = None,
) -> dict:
    """Render a batch of rays.

    Args:
        params: {"field": ``Field`` module, "t": (vocab, tau) table,
                 "t_s": optional separate semantic table}.
        rays: (B, 8) packed, scene-normalised.
        extras: (B, 4) packed sun_dir + ts.
        noise: (B, S) uniform draws for stratified jitter; None gives the
            deterministic ladder used for eval and serving.
    Returns:
        dict of per-ray outputs plus the per-sample tensors the losses read.
    """
    if rcfg.n_importance > 0:
        raise NotImplementedError(
            "n_importance > 0 (the hierarchical pass) is ported in a later slice"
        )
    fcfg = rcfg.field
    S = rcfg.n_samples
    xyz, z_vals = sample_rays(
        rays, S, noise=noise, perturb=rcfg.perturb if noise is not None else 0.0,
        given_z_vals=given_z_vals,
    )
    sun_d = extras_component(extras, "sun_d") if fcfg.has_sun else None
    view_dir = ray_component(rays, "directions") if fcfg.use_dir else None

    t_emb = t_s_emb = None
    if fcfg.has_beta:
        ts = extras_component(extras, "ts")[:, 0].to(torch.int32)
        t_emb = embedding_lookup(params["t"], ts)
        if params.get("t_s") is not None:
            t_s_emb = embedding_lookup(params["t_s"], ts)

    return _render_pass(params["field"], rcfg, rays, xyz, z_vals, sun_d,
                        view_dir, t_emb, t_s_emb)


def _render_pass(field, rcfg: RenderConfig, rays, xyz, z_vals, sun_d, view_dir,
                 t_emb, t_s_emb) -> dict:
    """One field evaluation + compositing pass at the given sample depths
    (with the solar-correction points folded into the same batch)."""
    fcfg = rcfg.field
    B = rays.shape[0]
    S = z_vals.shape[-1]

    run_sc = rcfg.solar_correction and fcfg.has_sun
    sc_stride = max(int(rcfg.sc_stride), 1) if run_sc else 1
    split_sc = run_sc and sc_stride > 1
    if split_sc and sc_stride > S // 2:
        # fewer than 2 sc rungs would kill the sc terms silently
        raise ValueError(
            f"sc_stride={sc_stride} leaves <2 sc rungs on a {S}-sample "
            f"ladder; use sc_stride <= n_samples // 2"
        )
    if run_sc:
        # the (possibly strided) z ladder marched along the sun direction;
        # the stride is anchored at the far end so it keeps the last rung
        origins = ray_component(rays, "origins")
        z_sc = z_vals[..., (S - 1) % sc_stride :: sc_stride] if split_sc else z_vals
        S_sc = z_sc.shape[-1]
        xyz_sc = origins[:, None, :] + sun_d[:, None, :] * z_sc[..., None]
        pts = torch.cat([xyz.reshape(-1, 3), xyz_sc.reshape(-1, 3)], dim=0)
    else:
        pts = xyz.reshape(-1, 3)

    def tile(x):
        if x is None:
            return None
        if run_sc:
            return torch.cat([_per_point(x, S), _per_point(x, S_sc)], dim=0)
        return _per_point(x, S)

    raw = field_forward(
        field, fcfg, pts, view_dir=tile(view_dir), sun_d=tile(sun_d),
        t_emb=tile(t_emb), t_s_emb=tile(t_s_emb),
        compute_dtype=None if rcfg.compute_dtype == "float32" else rcfg.dtype,
        n_full=B * S if run_sc else None,
    )

    def unflat(x, rows, n_s):
        if x.ndim == 1:
            return x.reshape(rows, n_s)
        return x.reshape(rows, n_s, x.shape[-1])

    n_main = B * S
    sig_m = unflat(raw["sigma"][:n_main], B, S)
    albedo = unflat(raw["rgb"], B, S)
    result = {"sigmas": sig_m, "albedo": albedo}

    if fcfg.has_sun:
        sun_v = unflat(raw["sun_v"][:n_main], B, S)
        sky = unflat(raw["sky"], B, S)
        # the sky head reads only the per-ray sun direction, so every sample
        # of a ray carries the same sky colour: the kernel takes it per ray
        w_m, transp_m, depth_m, rgb = composite(
            sig_m, z_vals, albedo, sun_v[..., 0], sky[:, 0, :]
        )
        result["sun"] = sun_v
        result["sky"] = sky
        result["irradiance"] = sun_v + (1.0 - sun_v) * sky
    else:
        w_m, depth_m, transp_m, _ = convert_sigmas(sig_m, z_vals)
        # classic NeRF composites without clamping
        rgb = torch.sum(w_m[..., None] * albedo, dim=-2)
    result.update(weights=w_m, depth=depth_m, transparency=transp_m, rgb=rgb)

    if fcfg.has_beta:
        result["beta"] = unflat(raw["beta"], B, S)

    if fcfg.has_semantic:
        logits_w = composite_scalar(w_m, unflat(raw["semantic"], B, S))
        result["semantic_logits"] = logits_w
        result["semantic_label"] = torch.argmax(logits_w, dim=-1)
        if "beta_s" in raw:
            result["beta_semantic"] = unflat(raw["beta_s"], B, S)

    if run_sc:
        sig_sc = unflat(raw["sigma"][n_main:], B, S_sc)
        w_sc, _, transp_sc, _ = convert_sigmas(sig_sc, z_sc)
        result["weights_sc"] = w_sc
        result["transparency_sc"] = transp_sc
        result["sun_sc"] = unflat(raw["sun_v"][n_main:], B, S_sc)

    return result


def _to_params_device(params: dict, device: torch.device) -> dict:
    return {k: (v.to(device) if v is not None else None) for k, v in params.items()}


@torch.inference_mode()
def render_image_chunked(
    params: dict,
    rcfg: RenderConfig,
    rays,
    extras,
    chunk: int = 8192,
    device=None,
) -> dict:
    """Deterministic full-image rendering in fixed-size chunks -> numpy.

    The last chunk is padded to ``chunk`` rows by repeating its last row,
    as the reference does, so every chunk has one shape.
    """
    dev = resolve_device(device)
    params = _to_params_device(params, dev)
    rays = torch.as_tensor(np.asarray(rays, np.float32))
    extras = torch.as_tensor(np.asarray(extras, np.float32))
    n = rays.shape[0]
    outs: list[dict] = []
    for i in range(0, n, chunk):
        r, e = rays[i : i + chunk], extras[i : i + chunk]
        pad = chunk - r.shape[0]
        if pad:
            r = torch.cat([r, r[-1:].expand(pad, -1)], dim=0)
            e = torch.cat([e, e[-1:].expand(pad, -1)], dim=0)
        res = render_rays(params, rcfg, r.to(dev), e.to(dev))
        keep = chunk - pad
        outs.append({k: v[:keep].cpu().numpy() for k, v in res.items()})
    return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
