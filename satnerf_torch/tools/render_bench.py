"""Inference render throughput on one card (counterpart of the JAX package's
``tools/render_bench.py``).

Renders 8,192-ray chunks of the flagship rs_semantic field (seed-0 weights)
in the inference configuration: bf16 products, the deterministic ladder,
no autograd, the solar-correction pass off (no eval, viz or serve consumer
reads its outputs) unless ``SATNERF_RENDER_SC=1``. Each chunk's rgb, depth
and semantic logits (and with the pass its sun visibility) are summed into
an accumulator on the card, read once a window, so no output goes unused.
Clock: CUDA events around ``SATNERF_RENDER_SCAN`` chunks, one warm window,
the best of three.

The JAX tool perturbs each chunk's rays by ``acc * 1e-30`` so that XLA
cannot hoist a loop-invariant render out of its scan. Eager PyTorch runs
every call it is given, so the rays stay as they are here.

Knobs (the JAX tool's): ``SATNERF_RENDER_SIN`` (poly, poly5, poly7f through
the fused field kernel; exact through the plain layer-by-layer field, with
``plain_field_calls`` in the line), ``SATNERF_RENDER_SC``,
``SATNERF_RENDER_DTYPE``, ``SATNERF_RENDER_CHUNK``, ``SATNERF_RENDER_SCAN``.

    python -m satnerf_torch.tools.render_bench

Prints one JSON line (``metric``, ``value``, ``unit``, ``ms_per_chunk``,
``config``, the card's name and power limit). Without a card it raises.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import torch

WINDOWS = 3


@dataclass(frozen=True)
class RenderSettings:
    chunk: int
    sin: str
    dtype: str
    with_sc: bool
    scan: int

    @property
    def config_desc(self) -> str:
        return (f"chunk{self.chunk}/{self.dtype}/{self.sin}" + ("/sc" if self.with_sc else "")
                + ("/plain" if self.sin == "exact" else ""))


def settings(env) -> RenderSettings:
    """The ``SATNERF_RENDER_*`` entries of ``env`` with the JAX tool's defaults."""
    return RenderSettings(chunk=int(env.get("SATNERF_RENDER_CHUNK", 8192)),
                          sin=env.get("SATNERF_RENDER_SIN", "poly"),
                          dtype=env.get("SATNERF_RENDER_DTYPE", "bfloat16"),
                          with_sc=env.get("SATNERF_RENDER_SC", "0") == "1",
                          scan=int(env.get("SATNERF_RENDER_SCAN", 50)))


def render_config(s: RenderSettings, device):
    from satnerf_torch.configs import resolve_trunk_impl
    from satnerf_torch.models.field import FieldConfig
    from satnerf_torch.render.renderer import RenderConfig

    fcfg = FieldConfig(variant="rs_semantic", mapping=True, siren=True, n_classes=5,
                       sin_impl=s.sin, trunk_impl=resolve_trunk_impl("xla", device))
    return RenderConfig(field=fcfg, n_samples=64, solar_correction=s.with_sc,
                        compute_dtype=s.dtype)


def render_chunk(params: dict, rcfg, rays, extras) -> dict:
    """One chunk on the deterministic ladder, without autograd."""
    from satnerf_torch.render.renderer import render_rays

    with torch.inference_mode():
        return render_rays(params, rcfg, rays, extras)


def chunk_sum(res: dict, with_sc: bool) -> torch.Tensor:
    keys = ("rgb", "depth", "semantic_logits") + (("sun_sc",) if with_sc else ())
    return sum(res[k].float().sum() for k in keys)


def main() -> dict:
    """Measure, print the line and return it."""
    from satnerf_torch.bench import synthetic_batch, timed_window
    from satnerf_torch.device import card_line, disable_tf32, resolve_device
    from satnerf_torch.models import field as field_mod
    from satnerf_torch.train.state import init_params

    dev = resolve_device(None)
    disable_tf32()
    s = settings(os.environ)
    rcfg = render_config(s, dev)
    params = init_params(torch.Generator().manual_seed(0), rcfg.field, t_vocab=50,
                         device=dev)
    b = synthetic_batch(s.chunk, device=dev)
    rays, extras = b["rays"], b["extras"]

    def window():
        acc = torch.zeros((), dtype=torch.float32, device=dev)

        def one():
            acc.add_(chunk_sum(render_chunk(params, rcfg, rays, extras), s.with_sc))

        ms, _ = timed_window(one, s.scan)
        total = float(acc)
        if not math.isfinite(total):
            raise RuntimeError(f"render_bench: non-finite outputs ({s.config_desc})")
        return ms

    with torch.inference_mode():
        window()
        plain0 = field_mod.PLAIN_CALLS
        best_ms = min(window() for _ in range(WINDOWS))
        plain = field_mod.PLAIN_CALLS - plain0
    if s.sin != "exact" and plain:
        raise RuntimeError(f"render_bench: {plain} plain field calls on the kernels' path")
    line = {
        "metric": "render_rays_per_sec_per_chip",
        "value": round(s.scan * s.chunk / (best_ms * 1e-3), 1),
        "unit": "rays/s",
        "ms_per_chunk": best_ms / s.scan,
        "config": s.config_desc,
        "card": card_line(),
    }
    if s.sin == "exact":
        line["plain_field_calls"] = plain
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
