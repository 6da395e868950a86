"""Host-to-card feed rate of the port's training loop (counterpart of the JAX
package's ``tools/feed_rate.py``).

Times what the trainer does per step outside the step itself
(``train/loop.py``): ``EpochSampler.next_batch()`` (a slice of the epoch's
permutation; a fresh permutation per epoch, amortised) and the copy of the
index vector to the card (``torch.from_numpy(idx).to(dev)``), the one
host-to-card transfer of a step: the ray store lives on the card and the
gather runs there. ``--spd K`` stacks K steps' indices into one copy.
The first epoch's permutation is drawn before the clock starts, as the
trainer's first step draws it; every later one is timed. The cards are
synchronised every 64 copies, so the queue stays deep and the copies held
alive stay few.

The port's data parallelism is one process per rank
(``parallel/multihost.py``); here ``--devices N`` splits each global batch
into N slices of batch/N indices, one to each of N cards, and raises when
fewer cards are present. The defaults are one card and 8,192 rays: one
rank's share of the JAX tool's 65,536 = 8 x 8,192.

    python -m satnerf_torch.tools.feed_rate [--rays N] [--batch B]
        [--devices D] [--spd K] [--steps S]

Prints a ``feed:`` line and a ``FEED_RATE`` line (rays_per_s, devices,
store_rays, the card's name and power limit). Without a card it raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

WINDOW = 64  # copies between synchronisations


def draw(sampler, spd: int) -> np.ndarray:
    """One dispatch's indices: (batch,), or (spd, batch) for ``spd`` > 1."""
    if spd == 1:
        return sampler.next_batch()
    return np.stack([sampler.next_batch() for _ in range(spd)])


def shards(idx: np.ndarray, n: int) -> list:
    """``n`` equal slices of the batch axis (the last one)."""
    return np.split(idx, n, axis=-1)


def feed(sampler, devices: list, spd: int, steps: int) -> float:
    """``steps`` dispatches of ``spd`` steps' indices, each split over
    ``devices`` and copied -> seconds on the host clock, synchronised."""
    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    sync()
    t0 = time.perf_counter()
    puts = []
    for _ in range(steps):
        for part, dev in zip(shards(draw(sampler, spd), len(devices)), devices):
            puts.append(torch.from_numpy(part).to(dev))
        if len(puts) >= WINDOW * len(devices):
            sync()
            puts.clear()
    sync()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    """Measure, print the lines and return the numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=27_648_000,
                    help="combined ray-store size (default: about a full scene)")
    ap.add_argument("--batch", type=int, default=8192,
                    help="global batch, split over --devices")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--spd", type=int, default=4,
                    help="steps per dispatch (indices stacked per copy)")
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args(argv)

    from satnerf_torch.device import card_line, resolve_device
    from satnerf_torch.train.data import EpochSampler

    resolve_device(None)
    if torch.cuda.device_count() < args.devices:
        raise RuntimeError(f"feed_rate: --devices {args.devices} but "
                           f"{torch.cuda.device_count()} cards present")
    if args.batch % args.devices:
        raise ValueError(f"feed_rate: --batch {args.batch} does not split over "
                         f"{args.devices} cards")
    devices = [torch.device("cuda", i) for i in range(args.devices)]
    sampler = EpochSampler(args.rays, args.batch, seed=0)
    sampler.next_batch()  # the first epoch's permutation, as the trainer's first step
    dt = feed(sampler, devices, args.spd, args.steps)
    rays = args.steps * args.spd * args.batch
    rate = rays / dt
    card = card_line()
    print(f"feed: {args.steps} dispatches x {args.spd} steps x {args.batch} rays "
          f"in {dt:.3f}s")
    print(f"FEED_RATE rays_per_s={rate:.0f} devices={args.devices} "
          f"store_rays={args.rays} card=\"{card}\"", flush=True)
    return {"rays_per_s": rate, "seconds": dt, "devices": args.devices,
            "store_rays": args.rays, "card": card}


if __name__ == "__main__":
    main()
