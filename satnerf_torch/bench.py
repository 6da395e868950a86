"""Training-throughput bench of the port on one card (counterpart of the JAX
package's root ``bench.py``).

Measures training rays per second of the full flagship step: the
RS-Semantic field (8x512 SIREN trunk and every head), 64 samples a ray, the
solar-correction pass, depth supervision, every loss term and the Adam
update, at the JAX bench's production settings: batch 8,192 plus 1,024 depth
rays, bf16 products, the degree-7 polynomial sine, ``sc_stride`` 2 (every
second solar-correction rung), the recompute trunk backward.

    python -m satnerf_torch.bench

The same ``SATNERF_BENCH_*`` variables as the JAX bench select a variant
(``settings``): ``BATCH``, ``REMAT_CHUNKS``, ``HIER`` (fine rungs of the
hierarchical pass; batch 4,096 and remat 2 unless set), ``SIN`` (poly,
poly5, poly7f, exact, auto), ``SC_STRIDE`` and ``BWD`` (recompute, stored,
auto: stored at batch <= 8,192). The JAX bench's ``IMPL`` (its XLA or
Pallas trunk) has no counterpart on the card, where the step runs the
kernels; it is not read. The label names the engine that ran:
``kernels``, or ``plain`` for the exact sine, which has no kernel
``SinMode`` and runs the layer-by-layer field (its line carries
``plain_field_calls``); there the trunk backward knob does nothing and is
reset to ``recompute``, as the JAX bench resets it off its Pallas trunk.
Every other setting holds ``models.field.PLAIN_CALLS`` at 0 in the
captured step, which every timed replay runs.

Clock: as the JAX bench scans each window of ``SCAN_STEPS`` steps in one
dispatch, each window here is one dispatch of ``SCAN_STEPS`` replays of one
captured step (``train/dispatch.py:StepGraph``), timed by CUDA events: a
warm window (one eager step, the capture, the rest replays), then three
timed windows; each window ends in a synchronise and a finite loss. The
line: ``metric``, ``value`` (rays/s of the best window, as the JAX bench
counts), ``unit``, ``vs_baseline`` (against the JAX bench's estimate of the
reference's single-GPU rate, 10 it/s x 1,024 rays), ``config``,
``dispatch`` (the replays a window), ``capture_s``, ``ms_per_step`` (the
best window's),
``rays_per_sec_all_windows`` and ``ms_per_step_all_windows`` (every timed
step over the three windows' summed time), ``window_ms`` and
``window_spread`` ((slowest - fastest) / fastest), the card's name and
power limit, and for ``sc_stride`` > 1 the quadrature note. A run that
cannot measure raises and prints no value; without a card it raises
before anything runs.
"""

from __future__ import annotations

import json
import math
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

REFERENCE_RAYS_PER_SEC = 10_240.0
DEPTH_RAYS = 1024
SCAN_STEPS = 50
WINDOWS = 3
SINES = ("poly", "poly5", "poly7f", "exact")
BWDS = ("recompute", "stored")


def synthetic_batch(b: int, seed: int = 0, semantic: bool = True, depth: int = 0, *,
                    device) -> dict:
    """The JAX bench's synthetic batch (``__graft_entry__.py:_batch``): the
    same numpy draws in the same order, as tensors on ``device``; the labels
    int32, as ``jnp.asarray`` makes them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (b, 3)).astype(np.float32)
    d = np.tile(np.array([[0.05, 0.05, -1.0]], np.float32), (b, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate(
        [o, d, np.zeros((b, 1), np.float32), np.ones((b, 1), np.float32)], 1)
    sun = np.tile(np.array([[0.3, 0.3, 0.9]], np.float32), (b, 1))
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    extras = np.concatenate([sun, rng.integers(0, 8, (b, 1)).astype(np.float32)], 1)
    batch = {"rays": rays, "extras": extras,
             "rgbs": rng.uniform(0, 1, (b, 3)).astype(np.float32)}
    if semantic:
        batch["semantic"] = rng.integers(0, 5, (b, 1)).astype(np.int32)
        batch["semantic_sparsity_mask"] = np.ones(b, dtype=bool)
    if depth:
        batch.update({"depth_rays": rays[:depth], "depth_extras": extras[:depth],
                      "depth_depths": np.full((depth,), 0.5, np.float32),
                      "depth_weights": np.ones((depth,), np.float32)})
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


@dataclass(frozen=True)
class BenchSettings:
    """One bench configuration; ``engine`` is what runs on the card."""

    batch: int
    remat_chunks: int
    hier: int
    sin: str
    sc_stride: int
    trunk_bwd: str
    engine: str  # "kernels" | "plain"

    @property
    def config_desc(self) -> str:
        return (f"batch{self.batch}/{self.engine}/chunks{self.remat_chunks}/bf16"
                + ("" if self.sin == "poly" else f"/{self.sin}")
                + ("" if self.trunk_bwd == "recompute" else f"/bwd-{self.trunk_bwd}")
                + ("" if self.sc_stride == 1 else f"/sc{self.sc_stride}")
                + ("" if self.hier == 0 else f"/hier{self.hier}"))


def settings(env) -> BenchSettings:
    """The bench configuration that the ``SATNERF_BENCH_*`` entries of
    ``env`` select (the JAX bench's rules and defaults, ``bench.py:92-142``,
    without its ``IMPL``). A bad sine or backward name raises ValueError."""
    batch = int(env.get("SATNERF_BENCH_BATCH", 8192))
    remat = int(env.get("SATNERF_BENCH_REMAT_CHUNKS", 0))
    hier = int(env.get("SATNERF_BENCH_HIER", 0))
    if hier > 0:  # the hierarchical production settings, unless overridden
        if "SATNERF_BENCH_BATCH" not in env:
            batch = 4096
        if "SATNERF_BENCH_REMAT_CHUNKS" not in env:
            remat = 2
    sin = env.get("SATNERF_BENCH_SIN", "poly")
    if sin == "auto":
        sin = "poly"
    if sin not in SINES:
        raise ValueError(f"SATNERF_BENCH_SIN={sin!r}: use poly, poly5, poly7f, exact, or auto")
    sc_stride = int(env.get("SATNERF_BENCH_SC_STRIDE", 2))
    bwd = env.get("SATNERF_BENCH_BWD", "recompute")
    if bwd == "auto":
        bwd = "stored" if batch <= 8192 else "recompute"
    if bwd not in BWDS:
        raise ValueError(f"SATNERF_BENCH_BWD={bwd!r}: use recompute, stored, or auto")
    plain = sin == "exact"
    if plain and bwd != "recompute":
        print(f"bench: SATNERF_BENCH_BWD={bwd} ignored on the plain field "
              f"(a knob of the kernels' backward)", file=sys.stderr)
        bwd = "recompute"
    return BenchSettings(batch=batch, remat_chunks=remat, hier=hier, sin=sin,
                         sc_stride=sc_stride, trunk_bwd=bwd,
                         engine="plain" if plain else "kernels")


def configs(s: BenchSettings, device):
    """-> (FieldConfig, RenderConfig, StepConfig) of the JAX bench's step
    (``bench.py:247-264``) under ``s``: on the card the kernels (the exact
    sine falls back to the plain field there), elsewhere the plain field."""
    from satnerf_torch.configs import resolve_trunk_impl
    from satnerf_torch.models.field import FieldConfig
    from satnerf_torch.render.renderer import RenderConfig
    from satnerf_torch.train.step import StepConfig

    fcfg = FieldConfig(variant="rs_semantic", mapping=True, siren=True, n_classes=5,
                       trunk_impl=resolve_trunk_impl("xla", device),
                       sin_impl=s.sin, trunk_bwd=s.trunk_bwd)
    rcfg = RenderConfig(field=fcfg, n_samples=64, solar_correction=True,
                        compute_dtype="bfloat16", remat_chunks=s.remat_chunks,
                        sc_stride=s.sc_stride, n_importance=s.hier,
                        use_fine_network=s.hier > 0)
    scfg = StepConfig(render=rcfg, steps_per_epoch=1000, sc_lambda=0.05, first_beta_epoch=0,
                      depth=True, semantic=True, car_index=4, use_car_reg_loss=True,
                      car_reg_loss_start=0)
    return fcfg, rcfg, scfg


def timed_window(fn, n: int) -> tuple:
    """``fn()`` ``n`` times between two CUDA events -> (ms, the last result),
    after a synchronise."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main(steps: int | None = None) -> dict:
    """Measure the configuration the environment selects, print its line and
    return it. ``steps`` (a window's steps, default ``SCAN_STEPS``) is for
    the card smoke run's variants only."""
    from satnerf_torch.device import card_line, disable_tf32, resolve_device
    from satnerf_torch.models import field as field_mod
    from satnerf_torch.train.dispatch import StepGraph
    from satnerf_torch.train.state import create_train_state, init_params
    from satnerf_torch.train.step import build_train_step

    dev = resolve_device(None)
    disable_tf32()
    s = settings(os.environ)
    n = SCAN_STEPS if steps is None else int(steps)
    fcfg, _, scfg = configs(s, dev)
    params = init_params(torch.Generator().manual_seed(0), fcfg, t_vocab=50, device=dev,
                         use_fine_network=s.hier > 0)
    state = create_train_state(params, 5e-4, steps_per_epoch=1000)
    step = build_train_step(scfg)
    batch = synthetic_batch(s.batch, depth=DEPTH_RAYS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    graph = StepGraph(state, lambda: step.update(state, batch, gen), gen)

    def replay():
        return graph.step()["loss"]

    def window(steps: int = n):
        ms, loss = timed_window(replay, steps)
        loss = float(loss)
        if not math.isfinite(loss):
            raise RuntimeError(f"bench: non-finite loss {loss} ({s.config_desc})")
        return ms

    # warm: one eager step (first launches, the allocator, what the step makes
    # on first use), the capture, and the window's other steps as replays
    step(state, batch, gen)
    plain0 = field_mod.PLAIN_CALLS
    graph.capture()
    plain_per_step = field_mod.PLAIN_CALLS - plain0  # what every replay runs
    if n > 1:
        window(n - 1)
    window_ms = [window() for _ in range(WINDOWS)]
    plain = plain_per_step * WINDOWS * n
    if s.engine == "kernels" and plain:
        raise RuntimeError(f"bench: {plain} plain field calls on the kernels' path")

    best_ms, all_ms = min(window_ms), sum(window_ms)
    rays_per_sec = n * s.batch / (best_ms * 1e-3)
    line = {
        "metric": "train_rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REFERENCE_RAYS_PER_SEC, 3),
        "config": s.config_desc,
        "dispatch": f"{n} replays of one captured step a window",
        "capture_s": graph.capture_seconds,
        "ms_per_step": best_ms / n,
        "rays_per_sec_all_windows": WINDOWS * n * s.batch / (all_ms * 1e-3),
        "ms_per_step_all_windows": all_ms / (WINDOWS * n),
        "window_ms": window_ms,
        "window_spread": (max(window_ms) - best_ms) / best_ms,
        "card": card_line(),
    }
    if s.engine == "plain":
        line["plain_field_calls"] = plain
    if s.sc_stride != 1:
        line["quadrature"] = (
            f"sc_stride={s.sc_stride} gate-passed strided sc quadrature "
            f"(docs/performance.md); reference-exact is sc_stride=1")
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
