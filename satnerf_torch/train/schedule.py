"""Learning-rate schedules (port of ``satnerf_tpu/train/schedule.py``):
"step" (0.9^epoch, the default), "exponential", "multistep", "cosine", with
epoch = step // steps_per_epoch."""

from __future__ import annotations

import math


def make_lr_schedule(base_lr: float, scheduler: str = "step",
                     steps_per_epoch: int = 1, num_epochs: int = 1):
    """step (int) -> learning rate (float)."""
    eps = 1e-8
    spe = max(int(steps_per_epoch), 1)
    if scheduler not in ("step", "exponential", "multistep", "cosine"):
        raise ValueError(f"lr scheduler not recognised: {scheduler}")

    def sched(step: int) -> float:
        epoch = int(step) // spe
        if scheduler == "step":
            return base_lr * 0.9**epoch
        if scheduler == "exponential":
            return base_lr * 0.01**epoch
        if scheduler == "multistep":
            return base_lr * 0.5 ** (int(epoch >= 2) + int(epoch >= 4) + int(epoch >= 8))
        frac = min(max(epoch / max(num_epochs, 1), 0.0), 1.0)
        return eps + (base_lr - eps) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return sched


def epoch_from_step(step: int, steps_per_epoch: int) -> int:
    return int(step) // max(int(steps_per_epoch), 1)
