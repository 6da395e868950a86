"""Positional (Fourier-feature) encoding (port of ``satnerf_tpu/core/encoding.py``).

x -> concat over frequencies f_k of [sin(f_k x), cos(f_k x)], with no
identity term; frequency-major order, [sin, cos] inner, each block of
width ``in_channels``.
"""

from __future__ import annotations

import numpy as np
import torch


def frequency_bands(n_freqs: int, logscale: bool = True) -> np.ndarray:
    if logscale:
        return 2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs)
    return np.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs)


def positional_encoding(x: torch.Tensor, n_freqs: int, logscale: bool = True):
    """Encode (..., C) -> (..., 2*n_freqs*C)."""
    if n_freqs == 0:
        return x[..., :0]
    freqs = torch.as_tensor(
        frequency_bands(n_freqs, logscale), dtype=x.dtype, device=x.device
    )
    xb = x[..., None, :] * freqs[:, None]  # (..., F, C)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., F, 2, C)
    return enc.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])


def encoded_size(n_freqs: int, in_channels: int) -> int:
    return 2 * n_freqs * in_channels
