"""Transient (per-image) embedding tables (port of
``satnerf_tpu/models/embeddings.py``): a (vocab, tau) table and a gather.

On the card the gather's backward is a one-hot sum over the rows, not
``index_select``'s own backward (``index_add_``, whose float atomics make
the table's gradient differ from run to run): a resumed run then repeats
the uninterrupted one bit for bit."""

from __future__ import annotations

import torch


def init_embedding(vocab: int, dim: int, generator: torch.Generator | None = None,
                   device=None, requires_grad: bool = False) -> torch.Tensor:
    """Standard-normal table, as ``torch.nn.Embedding`` initialises.
    ``requires_grad`` makes it a trainable leaf (its gradient reaches it
    through the field's aux input)."""
    t = torch.randn(vocab, dim, generator=generator, dtype=torch.float32)
    return t.to(device).requires_grad_(requires_grad)


class _DeterministicLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return torch.index_select(table, 0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        onehot = ids[:, None] == torch.arange(ctx.vocab, device=ids.device)
        return (onehot.to(grad.dtype)[:, :, None] * grad[:, None, :]).sum(0), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids (N,) integer -> (N, dim)."""
    ids = ids.to(torch.int64)
    if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
        return _DeterministicLookup.apply(table, ids)
    return torch.index_select(table, 0, ids)
