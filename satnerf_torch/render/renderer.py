"""Volume renderer: sampling + field + compositing (port of
``satnerf_tpu/render/renderer.py``), differentiable for training.

The solar-correction pass does not issue a second field call: its sample
points (the z ladder marched along the sun direction) are concatenated onto
the main batch, and the field prunes its heads there (``n_full``).

Per-ray outputs: irradiance = sun_v + (1 - sun_v) * sky,
rgb = clamp(sum w * albedo * irradiance); semantic logits composited with
the weights, then argmax. For variants with a sun head the main half's
weights, transparency, depth and rgb come from the fused compositing
kernel (``ops/composite.py``), whose backward is a kernel too; the
solar-correction half and the semantic composite stay plain PyTorch, as
they are XLA code (not kernels) in the reference.

With ``n_importance > 0`` a hierarchical pass follows: ``n_importance``
depths per ray drawn by inverse CDF from the coarse weights, merged with the
coarse ladder and rendered by the fine field (``params["fine"]`` with
``use_fine_network``, else the coarse one); the coarse result is nested
under ``"coarse"``. Under autograd, ``remat`` and ``remat_chunks > 1``
recompute the field in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` and its chunked scan do; without autograd
there is nothing to keep, so the field runs in one call per pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from satnerf_torch.core.compositing import composite_scalar, convert_sigmas
from satnerf_torch.core.rays import extras_component, ray_component
from satnerf_torch.core.sampling import sample_pdf, sample_rays
from satnerf_torch.device import resolve_device
from satnerf_torch.models.embeddings import embedding_lookup
from satnerf_torch.models.field import FieldConfig, field_forward
from satnerf_torch.ops.composite import composite
from satnerf_torch.parallel.mesh import gather_flat

# float64 runs the plain versions only (the kernels take f32 and bf16): the
# truth the f32 kernels are audited against
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering flags (same fields as the reference)."""

    field: FieldConfig
    n_samples: int = 64
    solar_correction: bool = True
    perturb: float = 1.0
    # hierarchical pass: n_importance inverse-CDF depths per ray, rendered by
    # params["fine"] with use_fine_network, else by the coarse field
    n_importance: int = 0
    use_fine_network: bool = False
    sc_stride: int = 1
    compute_dtype: str = "float32"  # "float32" | "bfloat16" | "float64"
    # training-memory knobs, under autograd only: recompute the field in the
    # backward (remat), or evaluate it in remat_chunks sequential tiles, each
    # recomputed in the backward (0/1 disables)
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
    generator: torch.Generator | None = None,
    u: torch.Tensor | None = None,
    global_rows: tuple | None = None,
) -> dict:
    """Render a batch of rays.

    Args:
        params: {"field": ``Field`` module, "t": (vocab, tau) table,
                 "t_s": optional separate semantic table, "fine": optional
                 fine ``Field`` for the hierarchical pass}.
        rays: (B, 8) packed, scene-normalised.
        extras: (B, 4) packed sun_dir + ts.
        noise: (B, S) uniform draws for stratified jitter; None gives the
            deterministic ladder used for eval and serving.
        generator: draws ``noise`` (on the rays' device) when it is not
            given, then ``u``: the training path's random sampling.
        u: (B, n_importance) uniform draws of the hierarchical pass; None
            (and no generator) gives its deterministic ladder.
        global_rows: (first row, rows) of a global batch whose rows
            ``rays`` are: the generator draws for the whole global batch and
            these rows take theirs, so a batch sharded over data-parallel
            ranks gets the draws of the one-process batch.
    Returns:
        dict of per-ray outputs plus the per-sample tensors the losses read;
        with ``n_importance > 0`` the fine pass's, with the coarse pass's
        nested under "coarse".
    """
    fcfg = rcfg.field
    S = rcfg.n_samples
    B = rays.shape[0]
    if generator is not None:
        lo, n_draw = (0, B) if global_rows is None else global_rows
        if noise is None and given_z_vals is None:
            noise = torch.rand((n_draw, S), generator=generator, dtype=rays.dtype,
                               device=rays.device)[lo : lo + B]
        if u is None and rcfg.n_importance > 0:
            u = torch.rand((n_draw, rcfg.n_importance), generator=generator,
                           dtype=rays.dtype, device=rays.device)[lo : lo + B]
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

    result = _render_pass(params["field"], rcfg, rays, xyz, z_vals, sun_d,
                          view_dir, t_emb, t_s_emb)
    if rcfg.n_importance <= 0:
        return result

    # inverse-CDF depths from the coarse weights (no gradient through them)
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, result["weights"][:, 1:-1].detach(), rcfg.n_importance,
                        u=u)
    z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
    origins = ray_component(rays, "origins")
    dirs = ray_component(rays, "directions")
    xyz_all = origins[:, None, :] + dirs[:, None, :] * z_all[..., None]
    fine_field = params.get("fine") if rcfg.use_fine_network else None
    fine = _render_pass(fine_field if fine_field is not None else params["field"], rcfg,
                        rays, xyz_all, z_all, sun_d, view_dir, t_emb, t_s_emb)
    fine["coarse"] = result
    return fine


def _eval_field(field, fcfg: FieldConfig, dt, n_full, pts, view_dir, sun_d, t_emb,
                t_s_emb) -> dict:
    return field_forward(field, fcfg, pts, view_dir=view_dir, sun_d=sun_d, t_emb=t_emb,
                         t_s_emb=t_s_emb, compute_dtype=dt, n_full=n_full)


def _chunked_eval(field, rcfg: RenderConfig, dt, pts, view_dir, sun_d, t_emb, t_s_emb,
                  heads: bool) -> dict:
    """The field over ``rcfg.remat_chunks`` sequential point tiles, each
    recomputed in the backward (the reference's checkpointed scan body). The
    last tile is padded by repeating the last row. ``heads=False``: sigma and
    sun_v only (n_full=0), for the solar-correction half."""
    n, k = pts.shape[0], rcfg.remat_chunks
    tile_n = -(-n // k)
    pad = tile_n * k - n

    def prep(x):
        if x is None or not pad:
            return x
        return torch.cat([x, x[-1:].expand(pad, -1)], dim=0)

    arrs = [prep(a) for a in (pts, view_dir, sun_d, t_emb, t_s_emb)]
    outs = []
    for c in range(k):
        part = [None if a is None else a[c * tile_n : (c + 1) * tile_n] for a in arrs]
        outs.append(checkpoint(_eval_field, field, rcfg.field, dt, None if heads else 0,
                               *part, use_reentrant=False, preserve_rng_state=False))
    return {key: torch.cat([o[key] for o in outs], dim=0)[: n if outs[0][key].shape[0] else 0]
            for key in outs[0]}


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

    dt = None if rcfg.compute_dtype == "float32" else rcfg.dtype
    under_grad = torch.is_grad_enabled()
    if rcfg.remat_chunks > 1 and under_grad:
        # the main (heads-on) and solar-correction (sigma + sun only) halves
        # in separate chunked evaluations, as the reference's scans
        per_ray = (view_dir, sun_d, t_emb, t_s_emb)
        raw = _chunked_eval(field, rcfg, dt, xyz.reshape(-1, 3),
                            *(None if x is None else _per_point(x, S) for x in per_ray),
                            heads=True)
        if run_sc:
            raw_sc = _chunked_eval(field, rcfg, dt, xyz_sc.reshape(-1, 3),
                                   *(None if x is None else _per_point(x, S_sc)
                                     for x in per_ray), heads=False)
            raw = dict(raw)
            for k in ("sigma", "sun_v"):
                raw[k] = torch.cat([raw[k], raw_sc[k]], dim=0)
    else:
        args = (field, fcfg, dt, B * S if run_sc else None, pts, tile(view_dir),
                tile(sun_d), tile(t_emb), tile(t_s_emb))
        if rcfg.remat and under_grad:
            raw = checkpoint(_eval_field, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            raw = _eval_field(*args)

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


def _padded_chunk(rays: torch.Tensor, extras: torch.Tensor, i: int, chunk: int):
    """Rows [i, i + chunk), the last chunk padded to ``chunk`` rows by
    repeating its last row, as the reference does -> (rays, extras, rows kept)."""
    r, e = rays[i : i + chunk], extras[i : i + chunk]
    pad = chunk - r.shape[0]
    if pad:
        r = torch.cat([r, r[-1:].expand(pad, -1)], dim=0)
        e = torch.cat([e, e[-1:].expand(pad, -1)], dim=0)
    return r, e, chunk - pad


def _render_chunk(params: dict, rcfg: RenderConfig, rays, extras) -> dict:
    """One deterministic render; the hierarchical pass's coarse result is
    kept as "<k>_coarse" per-ray outputs, its per-sample tensors dropped."""
    res = render_rays(params, rcfg, rays, extras)
    coarse = res.pop("coarse", None)
    if coarse is not None:
        for k in ("rgb", "depth", "semantic_logits", "semantic_label"):
            if k in coarse:
                res[f"{k}_coarse"] = coarse[k]
    return res


def _host_inputs(rays, extras):
    return (torch.as_tensor(np.asarray(rays, np.float32)),
            torch.as_tensor(np.asarray(extras, np.float32)))


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
    rays, extras = _host_inputs(rays, extras)
    outs: list[dict] = []
    for i in range(0, rays.shape[0], chunk):
        r, e, keep = _padded_chunk(rays, extras, i, chunk)
        res = _render_chunk(params, rcfg, r.to(dev), e.to(dev))
        outs.append({k: v[:keep].cpu().numpy() for k, v in res.items()})
    return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}


@torch.inference_mode()
def render_image_sharded(
    params: dict,
    rcfg: RenderConfig,
    rays,
    extras,
    layout,
    chunk: int = 8192,
    device=None,
) -> dict:
    """``render_image_chunked`` over the data-parallel ranks: each chunk's
    rows are split over the ranks (``layout.rows``), rendered, and gathered
    on every rank by one all-reduce per chunk (``parallel.mesh``). Every
    rank returns the whole image; the chunks are the single-process ones.
    """
    dev = resolve_device(device)
    params = _to_params_device(params, dev)
    rays, extras = _host_inputs(rays, extras)
    chunk = max(chunk, layout.world)
    rows = layout.rows(chunk)
    outs: list[dict] = []
    for i in range(0, rays.shape[0], chunk):
        r, e, keep = _padded_chunk(rays, extras, i, chunk)
        res = _render_chunk(params, rcfg, r[rows].to(dev), e[rows].to(dev))
        keys = list(res)
        full = gather_flat(layout, [res[k] for k in keys],
                            [(rows.start, chunk)] * len(keys), "render")
        outs.append({k: v[:keep].cpu().numpy() for k, v in zip(keys, full)})
    return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
