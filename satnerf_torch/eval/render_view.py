"""Novel-view rendering from a trained run (port of
``satnerf_tpu/eval/render_view.py``).

Renders any viewpoint (an RPC camera meta JSON, or a view name of the run's
dataset), with optional overrides of the sun direction (relighting through
the irradiance model) and of the transient embedding index (re-dating).
Writes RGB, depth, semantic-class and shaded-semantic PNGs
(``io/png.py``), and optionally an RGB GeoTIFF.

CLI:
    python -m satnerf_torch.eval.render_view <run_dp> <meta.json|view_name>
        [--out out_dir] [--sun_elevation E] [--sun_azimuth A] [--ts N]
        [--chunk 16384] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from satnerf_torch.core.rays import build_rays_from_rpc, construct_sun_dir
from satnerf_torch.datasets.satnerf_dataset import construct_rpc_camera_model
from satnerf_torch.device import resolve_device
from satnerf_torch.eval.loader import load_run
from satnerf_torch.io.json_io import read_json
from satnerf_torch.io.png import save_png
from satnerf_torch.logger import logger
from satnerf_torch.render.renderer import render_image_chunked
from satnerf_torch.serve.service import semantic_images
from satnerf_torch.viz.colormaps import apply_colormap


def build_view_rays(dataset, meta: dict, sun_elevation: float | None = None,
                    sun_azimuth: float | None = None, ts: int = 0):
    """Normalized rays + extras for an arbitrary RPC view meta.

    Returns (rays, extras, w, h, sun_elevation, sun_azimuth): the inputs of
    a full-image ``render_image_chunked`` of the view.
    """
    w, h = int(meta["width"]), int(meta["height"])
    cols, rows = np.meshgrid(np.arange(w), np.arange(h))
    rays = build_rays_from_rpc(
        construct_rpc_camera_model(meta), dataset.coordinate_system,
        rows=rows, cols=cols, min_alt=float(meta["min_alt"]), max_alt=float(meta["max_alt"]),
    )
    rays = dataset.normalization.normalize_rays(rays)

    el = sun_elevation if sun_elevation is not None else float(meta["sun_elevation"])
    az = sun_azimuth if sun_azimuth is not None else float(meta["sun_azimuth"])
    sun_dirs = construct_sun_dir(el, az, rays.shape[0])
    extras = np.concatenate([sun_dirs, np.full((rays.shape[0], 1), float(ts), np.float32)],
                            axis=1)
    return rays, extras, w, h, el, az


def render_view(input_dp: str, meta_fp: str, out: str | None = None,
                sun_elevation: float | None = None, sun_azimuth: float | None = None,
                ts: int = 0, chunk: int = 16384, save_tif: bool = False, device=None):
    """Render one novel view; returns the render's results dict."""
    dev = resolve_device(device)
    pipeline, params, rcfg, step = load_run(input_dp, device=dev)
    dataset = pipeline.datasets["rgb"]

    if not os.path.isfile(meta_fp):
        # a bare view name of the dataset ("SYN_001_002_RGB")
        meta_fp = os.path.join(dataset.meta_dp, meta_fp + ".json")
    meta = read_json(meta_fp)
    rays, extras, w, h, el, az = build_view_rays(dataset, meta, sun_elevation, sun_azimuth, ts)

    res = render_image_chunked(params, rcfg, rays, extras, chunk=chunk, device=dev)

    out = out or os.path.join(input_dp, "novel_views")
    os.makedirs(out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(meta_fp))[0]
    stem += f"_sun{el:.0f}-{az:.0f}_ts{int(ts)}_step{step}"

    rgb = np.clip(res["rgb"].reshape(h, w, 3) * 255.0, 0, 255).astype(np.uint8)
    save_png(rgb, os.path.join(out, stem + "_rgb.png"))
    depth_img = (apply_colormap(res["depth"].reshape(h, w), "jet") * 255).astype(np.uint8)
    save_png(depth_img, os.path.join(out, stem + "_depth.png"))

    if "semantic_label" in res:
        sem, shaded = semantic_images(res, h, w)
        save_png(sem, os.path.join(out, stem + "_semantic.png"))
        save_png(shaded, os.path.join(out, stem + "_semantic_shaded.png"))

    if save_tif:
        from satnerf_torch.io.image import save_output_image

        save_output_image(np.moveaxis(res["rgb"].reshape(h, w, 3), -1, 0).astype(np.float32),
                          os.path.join(out, stem + "_rgb.tif"))

    logger.info("RenderView", f"novel view written under {out} ({stem}_*.png)")
    return res


def main(argv=None):
    from satnerf_torch.eval.eval_nerf import _parse

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    args, kwargs = _parse(argv)
    for k in ("sun_elevation", "sun_azimuth"):
        if k in kwargs:
            kwargs[k] = float(kwargs[k])
    for k in ("ts", "chunk"):
        if k in kwargs:
            kwargs[k] = int(kwargs[k])
    render_view(*args, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
