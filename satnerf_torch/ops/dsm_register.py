"""Multiscale NCC DSM registration (host).

Native re-implementation of the reference's Numba kernels
(ref: eval/utils/dsmr.py:6-239): nan-aware 2x pyramid, exhaustive +-irange
shift search coarse-to-fine, then an affine z correction z -> a*z + b.
The hot loops run in C++ (ops/native.py); a vectorised numpy path covers
environments without the toolchain.
"""

from __future__ import annotations

import numpy as np

from satnerf_torch.ops import native


# -- primitives -------------------------------------------------------------


def downsample2x(u: np.ndarray) -> np.ndarray:
    """nan-aware 2x mean downsample of (h, w)."""
    u = np.ascontiguousarray(u, dtype=np.float64)
    lib = native.get_lib()
    h, w = u.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    if lib is not None:
        out = np.empty((oh, ow), dtype=np.float64)
        lib.sn_downsample2x(
            native.as_double_ptr(u), h, w, native.as_double_ptr(out)
        )
        return out
    # numpy fallback: pad to even with nan, 2x2 block nanmean
    ph, pw = oh * 2, ow * 2
    pad = np.full((ph, pw), np.nan)
    pad[:h, :w] = u
    blocks = pad.reshape(oh, 2, ow, 2).transpose(0, 2, 1, 3).reshape(oh, ow, 4)
    with np.errstate(invalid="ignore"):
        out = np.nanmean(blocks, axis=-1)
    return out


def mean_std(u: np.ndarray, v: np.ndarray, dx: int = 0, dy: int = 0):
    """(mu_u, mu_v, sig_u, sig_v, xcorr) over finite overlap of u and
    v-shifted-by-(dx, dy)."""
    u = np.ascontiguousarray(u, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    lib = native.get_lib()
    if lib is not None:
        out = np.empty(5, dtype=np.float64)
        cnt = lib.sn_mean_std(
            native.as_double_ptr(u), native.as_double_ptr(v),
            u.shape[0], u.shape[1], dx, dy, native.as_double_ptr(out),
        )
        assert cnt > 0, "The predicted DSM is all NaN"
        return tuple(out)
    us, vs = _overlap(u, v, dx, dy)
    m = np.isfinite(us) & np.isfinite(vs)
    assert m.sum() > 0, "The predicted DSM is all NaN"
    a, b = us[m], vs[m]
    mu, mv = a.mean(), b.mean()
    return (
        mu, mv,
        np.sqrt(((a - mu) ** 2).mean()),
        np.sqrt(((b - mv) ** 2).mean()),
        ((a - mu) * (b - mv)).mean(),
    )


def _overlap(u, v, dx, dy):
    """Views of u and shifted v over the valid index intersection."""
    h, w = u.shape
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y1 <= y0 or x1 <= x0:
        return u[:0, :0], v[:0, :0]
    return u[y0:y1, x0:x1], v[y0 + dy : y1 + dy, x0 + dx : x1 + dx]


def ncc(u, v, dx=0, dy=0) -> float:
    try:
        mu, mv, su, sv, xc = mean_std(u, v, dx, dy)
    except AssertionError:
        return 0.0
    denom = su * sv
    return float(xc / denom) if denom > 0 else 0.0


def _search(u, v, irange, initdx, initdy):
    lib = native.get_lib()
    if lib is not None:
        u = np.ascontiguousarray(u, dtype=np.float64)
        v = np.ascontiguousarray(v, dtype=np.float64)
        out = np.empty(2, dtype=np.int32)
        lib.sn_ncc_search(
            native.as_double_ptr(u), native.as_double_ptr(v),
            u.shape[0], u.shape[1], irange, initdx, initdy,
            native.as_int_ptr(out),
        )
        return int(out[0]), int(out[1])
    best, bdx, bdy = -np.inf, initdx, initdy
    for dy in range(initdy - irange, initdy + irange + 1):
        for dx in range(initdx - irange, initdx + irange + 1):
            corr = ncc(u, v, dx, dy)
            if corr > best:
                best, bdx, bdy = corr, dx, dy
    return bdx, bdy


def recursive_ncc(u, v, irange: int = 5, dx: int = 0, dy: int = 0):
    """Coarse-to-fine shift search (ref: dsmr.py:131-147)."""
    if min(u.shape) > 100:
        dx2, dy2 = recursive_ncc(
            downsample2x(u), downsample2x(v), irange, dx // 2, dy // 2
        )
        dx, dy = dx2 * 2, dy2 * 2
    return _search(u, v, irange, dx, dy)


# -- file-level interface (ref: dsmr.py:184-239) ---------------------------


def compute_shift(u: np.ndarray, v: np.ndarray, scaling: bool = True):
    """Shift + affine-z coefficients registering v onto u.

    Returns (dx, dy, a, b) with z -> a*z + b applied after the (dx, dy)
    lateral shift.
    """
    dx, dy = recursive_ncc(u, v)
    mu, mv, su, sv, _ = mean_std(u, v, dx, dy)
    a = su / sv if (scaling and sv > 0) else 1.0
    b = mu - mv * a
    return dx, dy, a, b


def apply_shift(v: np.ndarray, dx=0, dy=0, a=1.0, b=0.0, c=0.0, d=0.0):
    """out(j,i) = a * v(j+dy, i+dx) + b + c*i + d*j (nan outside)."""
    v = np.ascontiguousarray(v, dtype=np.float64)
    lib = native.get_lib()
    h, w = v.shape
    if lib is not None:
        out = np.empty((h, w), dtype=np.float64)
        lib.sn_apply_shift(
            native.as_double_ptr(v), h, w, int(dx), int(dy),
            float(a), float(b), float(c), float(d), native.as_double_ptr(out),
        )
        return out
    shifted = np.full((h, w), np.nan)
    us, vs = _overlap(shifted, v, int(dx), int(dy))
    us[...] = vs
    jj, ii = np.mgrid[0:h, 0:w]
    return a * shifted + b + c * ii + d * jj
