"""Blocks of steps per dispatch (port of the scanned blocks of
``satnerf_tpu/train/loop.py``, ``steps_per_dispatch``).

The JAX package compiles K training steps into one device program
(``lax.scan``). On the card the counterpart is a CUDA graph: the device work
of one whole step (the batch gather from the ray stores, the render through
K1/K3 and K5, the losses, the backward through K2, K4 and K5's backward, the
Adam update) captured once per step variant, with and without the depth
render, and replayed K times. Per replayed step the host copies the step's
indices into the graph's static index buffers (device to device: a block's
indices reach the card in one copy), writes the step and its learning rate
(``TrainState.feed``), reseeds the run's generator by ``step_seed``, replays
the graph and advances ``state.step``: the same arithmetic as the eager
step, so the run is bitwise that of K = 1.

* The first ``WARMUP_STEPS`` steps of each variant run eagerly, as real steps
  of the run: they make what the step builds on first use (the K1/K3 index
  tables of ``ops/trunk.py:tc_gather``, the encoding's bands, the kernels'
  shared-memory attributes, cuBLAS's state). Capture then records one step
  and advances nothing of the run: not the samplers, not ``state.step``, not
  the generator (registered with the graph, so a replay draws from the
  generator's state before it, as the eager step does).
* Both variants' graphs share one private memory pool; the depth variant
  runs only before the depth drop, so its graph is never replayed after the
  other is captured.
* A replay changes the parameters in place where autograd does not see it,
  so their version counters are bumped after each one
  (``models/field.py:Field.packed`` keys its cache on them).
* A capture that fails raises; no block runs eagerly in its place, and no
  exception of a replay is caught.

On the CPU, or with K = 1, every step is an eager call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from satnerf_torch.train.data import gather_batch

WARMUP_STEPS = 1  # eager steps of each variant before its capture


def step_seed(seed: int, step: int) -> int:
    """The per-step generator seed: a fixed mix of (seed, step)."""
    s = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(step)])
    hi, lo = s.generate_state(2, np.uint32)
    return (int(hi) & 0x7FFFFFFF) << 32 | int(lo)


class StepGraph:
    """One training step captured as a CUDA graph and replayed.

    ``body()`` is the step's device work on static inputs (its tensors stay
    where they are between replays), returning the step's metrics; it must
    read no host value and copy nothing from the host (``TrainState.feed``
    writes the step and learning rate before each replay)."""

    def __init__(self, state, body, generator: torch.Generator | None = None,
                 pool=None) -> None:
        self.state = state
        self.body = body
        self.generator = generator
        self.pool = pool
        self.graph = None
        self.outputs: dict | None = None  # the metrics of the last replay
        self.capture_seconds = 0.0
        self.replays = 0

    def capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool):
            self.outputs = self.body()
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph

    def step(self, seed: int | None = None) -> dict:
        """One training step by replay: feed the host step, reseed the
        generator (``seed`` not None), replay, advance the host's step."""
        state = self.state
        state.feed()
        if seed is not None:
            self.generator.manual_seed(seed)
        self.graph.replay()
        state.advance()
        for p in state.optimizer.params:
            torch.autograd.graph.increment_version(p)
        self.replays += 1
        return self.outputs


def _gather(store: dict, depth_store: dict | None, idx: torch.Tensor,
            didx: torch.Tensor | None) -> dict:
    """A step's batch: rows ``idx`` of the ray store and, with the depth
    render, rows ``didx`` of the tie points."""
    batch = gather_batch(store, idx)
    if didx is not None:
        batch.update(gather_batch(depth_store, didx, prefix="depth_"))
    return batch


@dataclass
class _Variant:
    """One step variant of the loop: its step function, eager steps so far,
    and once warmed up its graph and static index buffers."""

    train_step: object
    eager_steps: int = 0
    graph: StepGraph | None = None
    idx: torch.Tensor | None = None
    didx: torch.Tensor | None = None


class LoopDispatch:
    """The dispatches of ``Trainer.fit``: a block of consecutive steps that
    gather their batches by index from the ray stores on the device.

    ``steps`` maps ``use_depth`` to the step function (``build_train_step``)
    of each variant; ``graphs`` replays captured steps (the card with
    K > 1), else every step is an eager call."""

    def __init__(self, state, steps: dict, store: dict, depth_store: dict | None,
                 generator: torch.Generator, seed: int, graphs: bool) -> None:
        self.state = state
        self.variants = {k: _Variant(fn) for k, fn in steps.items() if fn is not None}
        self.store, self.depth_store = store, depth_store
        self.generator = generator
        self.seed = seed
        self.graphs = graphs
        self.pool = None  # one private pool for every variant's graph

    def run(self, idx: np.ndarray, didx: np.ndarray | None = None) -> dict:
        """Steps ``state.step`` .. + len(idx) - 1 on the (K, batch) indices
        ``idx`` and, with the depth render, the depth indices ``didx`` -> the
        last step's metrics."""
        v = self.variants[didx is not None]
        dev = next(iter(self.store.values())).device
        idx_t = torch.from_numpy(idx).to(dev)
        didx_t = torch.from_numpy(didx).to(dev) if didx is not None else None
        metrics = None
        for i in range(idx_t.shape[0]):
            d_i = didx_t[i] if didx_t is not None else None
            seed = step_seed(self.seed, self.state.step)
            if not self.graphs or v.eager_steps < WARMUP_STEPS:
                metrics = self._eager(v, idx_t[i], d_i, seed)
                continue
            if v.graph is None:
                self._capture(v, idx_t[i], d_i)
            v.idx.copy_(idx_t[i])
            if d_i is not None:
                v.didx.copy_(d_i)
            metrics = v.graph.step(seed)
        return metrics

    def _eager(self, v: _Variant, idx, didx, seed: int) -> dict:
        batch = _gather(self.store, self.depth_store, idx, didx)
        self.generator.manual_seed(seed)
        _, metrics = v.train_step(self.state, batch, self.generator)
        v.eager_steps += 1
        return metrics

    def _capture(self, v: _Variant, idx: torch.Tensor, didx: torch.Tensor | None) -> None:
        v.idx = idx.clone()
        v.didx = didx.clone() if didx is not None else None
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        # the body holds no reference back to the dispatch or the variant: a
        # cycle would keep the graph and its pool alive until a garbage
        # collection
        state, gen, update = self.state, self.generator, v.train_step.update
        store, depth_store, sidx, sdidx = self.store, self.depth_store, v.idx, v.didx

        def body() -> dict:
            return update(state, _gather(store, depth_store, sidx, sdidx), gen)

        v.graph = StepGraph(state, body, gen, self.pool)
        v.graph.capture()

    def graph_stats(self) -> dict:
        """{"depth" | "no_depth": {"capture_seconds", "replays", "eager_steps"}}."""
        return {("depth" if k else "no_depth"): {
                    "capture_seconds": v.graph.capture_seconds if v.graph else None,
                    "replays": v.graph.replays if v.graph else 0,
                    "eager_steps": v.eager_steps}
                for k, v in self.variants.items()}
