"""Polynomial sine engines of the SIREN activations, and their cosines
(the activations' derivatives), in plain PyTorch.

Port of ``satnerf_tpu/ops/fastmath.py``: the same constants and the same
reduce -> fold -> Horner body, with Python-static branches. The CUDA
kernels evaluate the identical arithmetic through ``csrc/sine.cuh``.

- Cody-Waite two-term range reduction to [-pi, pi] (exact for |x| <~ 1e3),
  or a one-term reduction for the fast variants;
- quadrant fold to [-pi/2, pi/2];
- odd minimax polynomial of degree 7 (degree 5 in :func:`fast_sin5`).

``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# 2*pi split so that PI2_HI is exactly representable in float32 and the
# product n*PI2_HI is exact for |n| < 2^16 (Cody-Waite reduction).
PI2_HI = 6.28125
PI2_LO = 2.0 * math.pi - PI2_HI
INV_PI2 = 1.0 / (2.0 * math.pi)
HALF_PI = math.pi / 2.0

# degree-7 minimax kernel on the [-pi/2, pi/2] fold (max abs err 1.75e-6)
S1 = -1.666516854544e-01
S2 = 8.305977379154e-03
S3 = -1.831411277453e-04

# degree-5 minimax kernel (max abs err 1.1e-4)
Q1 = -1.660786383418e-01
Q2 = 7.633781238515e-03

# single-float 2*pi of the one-term reduction
PI2_F32 = float(np.float32(2.0 * math.pi))


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: f32 for f32 and bf16 operands,
    f64 for f64 ones (an f64 run of a plain version is the kernels' truth)."""
    return torch.promote_types(dtype, torch.float32)


def _reduce(xf: torch.Tensor, two_term_reduction: bool) -> torch.Tensor:
    """r = x - 2pi * round(x / 2pi), in [-pi, pi] (f32, or f64 for f64)."""
    n = torch.round(xf * INV_PI2)
    if two_term_reduction:
        r = xf - n * PI2_HI
        return r - n * PI2_LO
    return xf - n * PI2_F32


def _poly(r: torch.Tensor, degree7: bool) -> torch.Tensor:
    """The odd minimax polynomial r + r^3 P(r^2) on [-pi/2, pi/2]."""
    r2 = r * r
    if degree7:
        p = S3 * r2 + S2
        p = p * r2 + S1
    else:
        p = Q2 * r2 + Q1
    return r + r * r2 * p


def _sin_poly(x: torch.Tensor, two_term_reduction: bool, degree7: bool):
    dtype = x.dtype
    r = _reduce(x.to(acc_dtype(x.dtype)), two_term_reduction)
    # fold [-pi, pi] -> [-pi/2, pi/2]: sin(pi - r) = sin(r)
    r = torch.where(r > HALF_PI, math.pi - r, r)
    r = torch.where(r < -HALF_PI, -math.pi - r, r)
    return _poly(r, degree7).to(dtype)


def _cos_poly(x: torch.Tensor, two_term_reduction: bool, degree7: bool):
    """cos(x) = sin(pi/2 - |r|) for r the [-pi, pi] reduction of x
    (``satnerf_tpu/ops/pallas/trunk.py:_cos_f32``): no fold needed."""
    dtype = x.dtype
    r = _reduce(x.to(acc_dtype(x.dtype)), two_term_reduction)
    return _poly(HALF_PI - torch.abs(r), degree7).to(dtype)


def fast_sin(x):
    """sin(x) to ~2e-6 abs error for |x| <= ~1e3 (``sin_impl="poly"``)."""
    return _sin_poly(x, two_term_reduction=True, degree7=True)


def fast_sin5(x):
    """One-term reduction + degree-5 kernel, ~1.5e-4 (``"poly5"``)."""
    return _sin_poly(x, two_term_reduction=False, degree7=False)


def fast_sin7f(x):
    """One-term reduction + degree-7 kernel, <= ~6e-5 (``"poly7f"``)."""
    return _sin_poly(x, two_term_reduction=False, degree7=True)


def fast_cos(x):
    """The cosine of the ``"poly"`` engine (same reduction and kernel)."""
    return _cos_poly(x, two_term_reduction=True, degree7=True)


def fast_cos5(x):
    """The cosine of the ``"poly5"`` engine."""
    return _cos_poly(x, two_term_reduction=False, degree7=False)


def fast_cos7f(x):
    """The cosine of the ``"poly7f"`` engine."""
    return _cos_poly(x, two_term_reduction=False, degree7=True)


# sin_impl names, in the order of the kernels' SinMode (csrc/sine.cuh)
SIN_MODES = ("poly", "poly5", "poly7f")
SINE_ENGINES = {"poly": fast_sin, "poly5": fast_sin5, "poly7f": fast_sin7f}
COSINE_ENGINES = {"poly": fast_cos, "poly5": fast_cos5, "poly7f": fast_cos7f}
