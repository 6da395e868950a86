"""Profiling: phase timing report + on-demand device trace capture (port of
``satnerf_tpu/train/profiling.py``).

``PhaseProfiler`` is the reference's. ``TraceCapture`` records a
``torch.profiler`` trace (CPU and CUDA activity) of a window of training
steps and writes it as a Chrome trace (``trace.json``, open in Perfetto or
chrome://tracing) beside ``trace_window.json``; it is enabled by the
``SATNERF_TORCH_PROFILE_DIR`` env var. With ``steps_per_dispatch`` > 1 the
window is aligned to the loop's blocks, as in the reference.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager


class PhaseProfiler:
    """Wall-clock accounting per named phase, dumped like SimpleProfiler."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'phase':<28}{'calls':>8}{'total_s':>12}{'mean_ms':>12}"]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<28}{c:>8}{t:>12.3f}{t / c * 1e3:>12.3f}")
        return "\n".join(lines)

    def dump(self, run_dp: str) -> None:
        os.makedirs(run_dp, exist_ok=True)
        with open(os.path.join(run_dp, "profiler.txt"), "w") as f:
            f.write(self.report() + "\n")


class TraceCapture:
    """Capture a ``torch.profiler`` trace over a step window.

    Enabled when SATNERF_TORCH_PROFILE_DIR is set; captures steps
    [start, start+n) once per run.
    """

    def __init__(self, start_step: int = 20, n_steps: int = 10) -> None:
        self.dir = os.environ.get("SATNERF_TORCH_PROFILE_DIR")
        self.start = start_step
        self.stop = start_step + n_steps
        self._prof = None
        self._done = False
        self._covered_first: int | None = None
        self._covered_last: int | None = None
        self._blocks: set[int] = set()

    def step(self, step: int, block: int = 1) -> None:
        """Called once per dispatch, which covers steps [step, step + block).

        A dispatch is the finest unit the trace can start or stop at, so the
        window is aligned to blocks: the trace starts at the first dispatch
        that overlaps [start, stop), and the covered step range and the
        block sizes go to trace_window.json beside the trace."""
        if self.dir is None or self._done:
            return
        if self._prof is not None and step >= self.stop:
            self.close()
            return
        if self._prof is None and step + block > self.start and step < self.stop:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._covered_first = step
        if self._prof is not None:
            self._covered_last = step + block - 1
            self._blocks.add(block)

    def _write_window(self) -> None:
        import json

        with open(os.path.join(self.dir, "trace_window.json"), "w") as f:
            json.dump({"first_step": self._covered_first,
                       "last_step": self._covered_last,
                       # every dispatch size in the window (blocks shrink to
                       # 1 at log steps, epoch ends, the depth drop)
                       "steps_per_dispatch": max(self._blocks or {1}),
                       "block_sizes": sorted(self._blocks)}, f)

    def close(self) -> None:
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
            self._prof = None
            self._done = True
            self._write_window()
