"""Transient (per-image) embedding tables (port of
``satnerf_tpu/models/embeddings.py``): a (vocab, tau) table and a gather."""

from __future__ import annotations

import torch


def init_embedding(vocab: int, dim: int, generator: torch.Generator | None = None,
                   device=None) -> torch.Tensor:
    """Standard-normal table, as ``torch.nn.Embedding`` initialises."""
    return torch.randn(vocab, dim, generator=generator, dtype=torch.float32,
                       device=device)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids (N,) integer -> (N, dim)."""
    return torch.index_select(table, 0, ids.to(torch.int64))
