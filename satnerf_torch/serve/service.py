"""RenderService: field weights loaded once onto the card, rendered many times
(port of ``satnerf_tpu/serve/service.py``).

Weights stay resident on the device, already packed for the kernels (K1's
whole field, or K3's trunk for the ablation fields); a hierarchical model's
fine field is kept beside the coarse one and renders the fine pass. A lock
serialises device access, and ``stats()`` counts requests, rays and render
seconds. The solar-correction pass is off, as in every eval/serve consumer
of the reference (satnerf_tpu/eval/loader.py).

``RenderService.from_run`` / ``load_service`` start from a trained run
directory (``eval/loader.py``) and add ``render(view)``: a view name, meta
path or meta dict -> RPC rays on the host (``eval/render_view.py``) -> the
chunked render; ``serve/http_server.py`` puts it behind HTTP.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import replace

import numpy as np

from satnerf_torch.configs import load_render_config
from satnerf_torch.device import disable_tf32, resolve_device
from satnerf_torch.io.json_io import read_json
from satnerf_torch.logger import logger
from satnerf_torch.models.import_params import load_lightning_ckpt, resident_params
from satnerf_torch.render.renderer import RenderConfig, render_image_chunked

# class colour map (uint8 RGB per class id + one spare row): ground, water,
# vegetation, buildings, cars, spare
SEMANTIC_CLASS_COLOR_MAPPING = np.array(
    [
        [229, 232, 157],
        [35, 161, 228],
        [9, 171, 120],
        [138, 138, 138],
        [193, 79, 69],
        [98, 98, 98],
    ],
    dtype=np.uint8,
)


def semantic_images(res: dict, h: int, w: int) -> tuple:
    """(class colours, shaded class colours) as (h, w, 3) uint8 from a
    render's ``semantic_label``, ``weights`` and ``sun``: the paper's
    lighting-scalar shaded semantic rendering."""
    colors = SEMANTIC_CLASS_COLOR_MAPPING
    labels = np.asarray(res["semantic_label"]).reshape(h, w)
    sem = colors[np.clip(labels, 0, len(colors) - 1)].astype(np.uint8)
    shading = (np.asarray(res["weights"])[..., None] * np.asarray(res["sun"])).sum(-2)
    return sem, (sem * shading.reshape(h, w, 1)).astype(np.uint8)


class RenderService:
    """Persistent renderer over one set of field weights.

    ``params``: {"field": ``Field`` module or its state dict, "fine":
    optional fine field (module or state dict), "t": (vocab, tau) table,
    "t_s": optional table}.

    A service made by :meth:`from_run` also knows its run: ``render(view,
    ...)`` accepts a dataset view name ("SYN_001_002_RGB"), a path to an RPC
    meta JSON, or an already-parsed meta dict, plus the paper's relight and
    re-date overrides (sun elevation and azimuth in degrees, transient
    timestamp index).
    """

    def __init__(self, params: dict, rcfg: RenderConfig, chunk: int = 16384,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()  # the plain f32 path runs in full f32, as JAX does
        self.rcfg = replace(rcfg, solar_correction=False)
        self.chunk = int(chunk)
        self.params = resident_params(params, self.rcfg, self.device)
        self.fast_sine = self.rcfg.field.sin_impl == "poly5"
        # the run behind the weights (from_run), for render(view)
        self.run_dp: str | None = None
        self.step = 0
        self.pipeline = None
        self.dataset = None
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "rays": 0, "render_seconds": 0.0}

    @classmethod
    def from_run(cls, run_dp: str, epoch: int | None = None, chunk: int = 16384,
                 fast_sine: bool = False, device=None) -> "RenderService":
        """A trained run directory -> service (checkpoint by epoch, else
        best, else last; the run's datasets give the views).

        ``fast_sine`` renders with the degree-5 sine ("poly5"), which the
        kernels cover too. The JAX package measured the eval-time swap as
        metric-free on trained checkpoints (docs/performance.md "quality
        gate"); the altitude bias of poly5 arises only from training with it.
        """
        from satnerf_torch.eval.loader import load_run

        dev = resolve_device(device)
        pipeline, params, rcfg, step = load_run(run_dp, epoch, device=dev)
        if fast_sine:
            rcfg = replace(rcfg, field=replace(rcfg.field, sin_impl="poly5"))
        svc = cls(params, rcfg, chunk=chunk, device=dev)
        svc.run_dp = run_dp
        svc.step = step
        svc.pipeline = pipeline
        svc.dataset = pipeline.datasets["rgb"]
        return svc

    @classmethod
    def from_checkpoint(cls, ckpt_fp: str, pipeline_toml: str, n_classes: int = 5,
                        chunk: int = 16384, device=None, **overrides):
        """Reference-format checkpoint + pipeline TOML -> service; a
        checkpoint with ``model_fine.*`` entries serves its fine field in the
        hierarchical pass. ``overrides`` replace pipeline keys (e.g.
        ``trunk_impl="pallas"``)."""
        dev = resolve_device(device)
        rcfg = load_render_config(pipeline_toml, n_classes=n_classes,
                                  device=dev, **overrides)
        return cls(load_lightning_ckpt(ckpt_fp), rcfg, chunk=chunk, device=dev)

    def render_rays(self, rays, extras, h: int, w: int) -> dict:
        """Render (h*w, 8) rays with (h*w, 4) extras; returns (h, w, ...)
        numpy arrays: rgb in [0, 1], depth, and for semantic models
        semantic_label, semantic_rgb and semantic_shaded_rgb."""
        rays = np.asarray(rays, np.float32)
        if rays.shape[0] != h * w:
            raise ValueError(f"{rays.shape[0]} rays for a {h}x{w} image")
        with self._lock:
            t0 = time.monotonic()
            res = render_image_chunked(self.params, self.rcfg, rays, extras,
                                       chunk=self.chunk, device=self.device)
            dt = time.monotonic() - t0
            self._stats["requests"] += 1
            self._stats["rays"] += int(rays.shape[0])
            self._stats["render_seconds"] += dt

        out = {
            "rgb": np.clip(res["rgb"].astype(np.float32), 0, 1).reshape(h, w, 3),
            "depth": res["depth"].astype(np.float32).reshape(h, w),
        }
        if "semantic_label" in res:
            out["semantic_label"] = res["semantic_label"].reshape(h, w)
            out["semantic_rgb"], out["semantic_shaded_rgb"] = semantic_images(res, h, w)
        return out

    # ------------------------------------------------------------------ api
    def _run_dataset(self):
        if self.dataset is None:
            raise ValueError("this service has no run: build it with from_run")
        return self.dataset

    def metadata(self) -> dict:
        f = self.rcfg.field
        return {
            "run_dp": self.run_dp,
            "step": self.step,
            "variant": f.variant,
            "n_classes": f.n_classes if f.has_semantic else 0,
            "views": self.view_names(),
            "chunk": self.chunk,
            "fast_sine": self.fast_sine,
            # kept for the reference's API: the swap study shows the
            # eval-time engine does not change served depth quality
            "depth_quality": "poly5_fast_sine" if self.fast_sine else "exact",
        }

    def view_names(self) -> list[str]:
        return [d["name"] for d in self._run_dataset().data]

    def resolve_meta(self, view, allow_paths: bool = True) -> dict:
        """View name / meta path / meta dict -> meta dict.

        ``allow_paths=False`` (the HTTP front end) restricts views to plain
        names resolving inside the dataset's meta dir, so a remote client
        can neither probe arbitrary JSON files through names like
        ``"../../etc/foo"`` or absolute paths, nor post a raw meta dict with
        an unbounded width x height (the rays are built on the host before
        any chunking). The path and dict forms stay open to the Python API.
        """
        dataset = self._run_dataset()
        if isinstance(view, dict):
            if not allow_paths:
                raise ValueError(
                    "inline meta dicts are not accepted over HTTP; use a known view name"
                )
            return view
        if allow_paths and os.path.isfile(str(view)):
            return read_json(str(view))
        fp = os.path.join(dataset.meta_dp, str(view) + ".json")
        meta_root = os.path.realpath(dataset.meta_dp)
        if os.path.commonpath([meta_root, os.path.realpath(fp)]) != meta_root:
            raise KeyError(f"view name {view!r} escapes the meta directory")
        if not os.path.isfile(fp):
            # no path in the message: HTTP 400 bodies echo it
            raise KeyError(f"unknown view {view!r}")
        return read_json(fp)

    def warmup(self) -> float:
        """Render the first view once (builds and loads the kernels, packs
        the weights); returns host seconds."""
        t0 = time.monotonic()
        names = self.view_names()
        if names:
            self.render(names[0])
        return time.monotonic() - t0

    def render(self, view, sun_elevation: float | None = None,
               sun_azimuth: float | None = None, ts: int = 0,
               allow_paths: bool = True) -> dict:
        """Render one view; returns (H, W, ...) numpy arrays as
        :meth:`render_rays` does, plus the sun angles and ``ts`` used."""
        from satnerf_torch.eval.render_view import build_view_rays

        meta = self.resolve_meta(view, allow_paths=allow_paths)
        rays, extras, w, h, el, az = build_view_rays(
            self._run_dataset(), meta, sun_elevation, sun_azimuth, ts
        )
        out = self.render_rays(rays, extras, h, w)
        out.update(sun_elevation=el, sun_azimuth=az, ts=int(ts))
        return out

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        s["rays_per_second"] = (
            s["rays"] / s["render_seconds"] if s["render_seconds"] else 0.0
        )
        return s


def load_service(run_dp: str, epoch: int | None = None, chunk: int = 16384,
                 warmup: bool = True, fast_sine: bool = False,
                 device=None) -> RenderService:
    svc = RenderService.from_run(run_dp, epoch=epoch, chunk=chunk,
                                 fast_sine=fast_sine, device=device)
    if warmup:
        dt = svc.warmup()
        logger.info("Serve", f"warmed up in {dt:.1f}s (kernel load and packing included)")
    return svc
