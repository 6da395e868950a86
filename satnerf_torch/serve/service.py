"""RenderService: field weights loaded once onto the card, rendered many times
(port of ``satnerf_tpu/serve/service.py``).

Weights stay resident on the device, already packed for the fused field
kernel; a lock serialises device access, and ``stats()`` counts requests,
rays and render seconds. The solar-correction pass is off, as in every
eval/serve consumer of the reference (satnerf_tpu/eval/loader.py).

Not ported yet: ``render(view)`` (RPC view resolution) and the HTTP front
end, which come with the host layer.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace

import numpy as np
import torch

from satnerf_torch.configs import load_render_config
from satnerf_torch.device import disable_tf32, resolve_device
from satnerf_torch.models.field import Field, use_fused_field
from satnerf_torch.models.import_params import load_lightning_ckpt
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


class RenderService:
    """Persistent renderer over one set of field weights.

    ``params``: {"field": ``Field`` module or its state dict, "t": (vocab,
    tau) table, "t_s": optional table}.
    """

    def __init__(self, params: dict, rcfg: RenderConfig, chunk: int = 16384,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()  # the plain f32 path runs in full f32, as JAX does
        self.rcfg = replace(rcfg, solar_correction=False)
        self.chunk = int(chunk)
        field = params["field"]
        if not isinstance(field, Field):
            state = field
            field = Field(self.rcfg.field)
            field.load_state_dict(state)
        field = field.to(self.device).eval()
        self.params = {"field": field}
        for key in ("t", "t_s"):
            if params.get(key) is not None:
                self.params[key] = torch.as_tensor(params[key]).to(
                    self.device, torch.float32
                )
        if use_fused_field(self.rcfg.field):
            field.packed(self.rcfg.dtype)  # pack once, keep on the device
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "rays": 0, "render_seconds": 0.0}

    @classmethod
    def from_checkpoint(cls, ckpt_fp: str, pipeline_toml: str, n_classes: int = 5,
                        chunk: int = 16384, device=None, **overrides):
        """Reference-format checkpoint + pipeline TOML -> service.
        ``overrides`` replace pipeline keys (e.g. ``trunk_impl="pallas"``)."""
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
            colors = SEMANTIC_CLASS_COLOR_MAPPING
            labels = res["semantic_label"].reshape(h, w)
            out["semantic_label"] = labels
            sem = colors[np.clip(labels, 0, len(colors) - 1)]
            out["semantic_rgb"] = sem.astype(np.uint8)
            shading = (res["weights"][..., None] * res["sun"]).sum(-2).reshape(h, w, 1)
            out["semantic_shaded_rgb"] = (sem * shading).astype(np.uint8)
        return out

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        s["rays_per_second"] = (
            s["rays"] / s["render_seconds"] if s["render_seconds"] else 0.0
        )
        return s
