"""On-device ray store and epoch-permutation batching (port of
``satnerf_tpu/train/data.py``).

The combined ray store moves to the device once; every step gathers a
fixed-size batch by indices (``index_select``), so the steady-state host ->
device traffic is one small index vector per step. Epoch semantics
(shuffled, without replacement) and per-epoch subsampling come from a
host-side permutation per epoch: ``EpochSampler`` is the reference's,
line for line, so the index stream is the JAX package's bit for bit.

The depth loader cycles with its own permutation, like Lightning's
max_size_cycle combined loader.
"""

from __future__ import annotations

import numpy as np
import torch

from satnerf_torch.device import resolve_device

TRAIN_KEYS = (
    "rays",
    "rgbs",
    "extras",
    "semantic",
    "semantic_sparsity_mask",
)
DEPTH_KEYS = ("rays", "extras", "depths", "weights")


def device_store(combined: dict, keys=TRAIN_KEYS, device=None) -> dict:
    """Move the combined arrays to ``device`` (None: the card)."""
    dev = resolve_device(device)
    store = {}
    for k in keys:
        if k not in combined:
            continue
        v = combined[k]
        if k == "semantic":
            v = v.astype(np.int32)
        elif v.dtype != np.bool_:
            v = v.astype(np.float32)
        store[k] = torch.as_tensor(np.ascontiguousarray(v), device=dev)
    return store


def gather_batch(store: dict, idx: torch.Tensor, prefix: str = "") -> dict:
    """Index a batch out of the store (``idx`` on the store's device)."""
    return {prefix + k: torch.index_select(v, 0, idx) for k, v in store.items()}


class EpochSampler:
    """Host-side permutation stream: shuffled epochs without replacement.

    ``subsample`` (0<frac<=1 or absolute count) draws a fresh random subset
    each epoch.
    """

    def __init__(
        self,
        n: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        subsample: float | int | None = None,
    ) -> None:
        self.n = int(n)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.subsample = subsample
        assert self.epoch_size >= self.batch_size, (
            f"dataset ({self.epoch_size} rays/epoch) smaller than one batch"
        )
        self._perm = np.empty(0, dtype=np.int32)
        self._pos = 0
        self.epoch = -1  # becomes 0 on the first batch

    @property
    def epoch_size(self) -> int:
        if self.subsample is None:
            return self.n
        if 0 < self.subsample <= 1:
            return max(int(self.subsample * self.n), self.batch_size)
        return min(int(self.subsample), self.n)

    @property
    def steps_per_epoch(self) -> int:
        return max(self.epoch_size // self.batch_size, 1)

    def _new_epoch(self) -> None:
        size = self.epoch_size
        if self.shuffle:
            if size < self.n:
                perm = self.rng.choice(self.n, size=size, replace=False)
            else:
                perm = self.rng.permutation(self.n)
        elif size < self.n:
            # subsampling promises a fresh random subset each epoch even
            # with in-epoch shuffling off
            perm = np.sort(self.rng.choice(self.n, size=size, replace=False))
        else:
            perm = np.arange(size)
        self._perm = perm.astype(np.int32)
        self._pos = 0

    def next_batch(self) -> np.ndarray:
        """Next batch of indices; drops the ragged epoch tail (fixed shapes,
        like a torch DataLoader with drop_last)."""
        if self._pos + self.batch_size > self._perm.size:
            self._new_epoch()
            if self._perm.size:
                self.epoch += 1
        out = self._perm[self._pos : self._pos + self.batch_size]
        self._pos += self.batch_size
        return out

    def fast_forward(self, n_batches: int) -> None:
        """Advance the stream as if ``n_batches`` had already been drawn
        (checkpoint resume), replaying next_batch's epoch/pos state machine
        without materialising batches."""
        for _ in range(int(n_batches)):
            if self._pos + self.batch_size > self._perm.size:
                self._new_epoch()
                if self._perm.size:
                    self.epoch += 1
            self._pos += self.batch_size
