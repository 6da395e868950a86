"""Image quality metrics: MSE / PSNR / SSIM (port of
``satnerf_tpu/eval/metrics.py``).

SSIM is the Wang et al. formula with a gaussian window (default size 3,
sigma 1.5) and zero 'same' padding. The window is applied as a sum of
shifted, weighted copies of the image in f32, with no library convolution:
on the card cuDNN may run an f32 convolution in TF32, whose error in
filt(x*x) - mu*mu exceeds c2 in low-variance windows and pushes the SSIM
index past 1.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32) if not torch.is_tensor(x) else x.float()


def mse(pred, gt, valid_mask=None):
    err = (_t(pred) - _t(gt)) ** 2
    if valid_mask is not None:
        m = _t(valid_mask)
        return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1)
    return torch.mean(err)


def psnr(pred, gt, valid_mask=None):
    return -10.0 * torch.log10(mse(pred, gt, valid_mask))


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma**2)
    )
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter(img: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """(H, W, C) -> the window's weighted sum at every pixel, zero padding."""
    k = win.shape[0]
    r = (k - 1) // 2  # XLA's 'SAME': the odd pad goes after
    h, w = img.shape[:2]
    pad = torch.nn.functional.pad(img.permute(2, 0, 1), (r, k - 1 - r, r, k - 1 - r))
    out = torch.zeros_like(img.permute(2, 0, 1))
    for dy in range(k):
        for dx in range(k):
            out = out + float(win[dy, dx]) * pad[:, dy:dy + h, dx:dx + w]
    return out.permute(1, 2, 0)


def ssim(pred, gt, window_size: int = 3, sigma: float = 1.5):
    """Mean SSIM index of two (H, W, C) (or (H, W)) images in [0, 1]."""
    pred, gt = _t(pred), _t(gt)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    win = _gaussian_window(window_size, sigma)

    mu1, mu2 = _filter(pred, win), _filter(gt, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sig1 = _filter(pred * pred, win) - mu1_sq
    sig2 = _filter(gt * gt, win) - mu2_sq
    sig12 = _filter(pred * gt, win) - mu12

    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * sig12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sig1 + sig2 + c2)
    )
    return torch.mean(ssim_map)
