"""Native bundle adjustment: in-repo replacement for sat-bundleadjust (a
copy of ``satnerf_tpu/data_prep/ba.py``).

The reference's BA step (ref: data_prep/processing/step_bundle_adjustment.py:14-115)
shells out to the external sat-bundleadjust/s2p toolchain (SIFT tracks +
RPC bias correction); that stack is no dependency of this package. This module
is a self-contained equivalent producing the exact output contract the
reference's pipeline consumes (``ba_params/{pts3d,pts2d,cam_ind,pts_ind}.npy``,
``geotiff_paths.txt``, ``rpcs_adj/*.rpc_adj`` — see
steps/step_bundle_adjustment.py:_copy_precomputed):

1. **Corners** — Harris response + non-max suppression per view (numpy).
2. **Matching** — RPC-constrained: a corner's epipolar locus in another view is
   its localization swept over the scene's altitude range, reprojected; only
   corners near the locus are ZNCC-scored (mutual-best + threshold). This is
   the satellite-frame analogue of epipolar-constrained matching and keeps
   the candidate set tiny without any external feature library.
3. **Tracks** — union-find over pairwise matches; components observing
   >= 2 distinct views (view-conflicted components dropped).
4. **Triangulation** — per-track altitude-grid initialisation (reference
   view localization reprojected into the others) + damped Gauss-Newton on
   (lon, lat, alt), vectorised over all tracks with finite-difference
   Jacobians (3x3 normal equations solved batched).
5. **Bias adjustment** — alternating least squares between the tracks and a
   per-view (d_col, d_row) RPC bias (the correction sat-bundleadjust's
   adjusted cameras encode); view 0 is the gauge anchor. One outlier
   rejection round (residual > max(2 px, 3x median)).

Everything runs in float64 numpy: the geometry solve is host-side data
preparation (as in the reference), and raw lon/lat magnitudes need f64.

Measured accuracy envelope (synthetic 4-view scenes, tests/test_ba_native.py):
the geometry solver recovers injected per-view camera biases to < 0.2 px
modulo the translation gauge; end-to-end, patch matching itself carries a
~1 px per-view-pair systematic (view-dependent parallax distortion of the
patches — a high-pass pre-filter was measured to make it worse: 0.97 ->
1.41 px gauge residual at 144², while reprojection improved 0.59 -> 0.37 px),
which bounds the achievable bias decomposition the same way descriptor
localisation bounds SIFT-based BA. The delivered solution is sub-pixel
self-consistent (points + adjusted cameras), which is what depth
supervision consumes.
"""

from __future__ import annotations

import os

import numpy as np

from satnerf_torch.geo.ellipsoid import latlon_to_ecef
from satnerf_torch.geo.rpc import RPCModel
from satnerf_torch.logger import logger

# -----------------------------------------------------------------------
# corners
# -----------------------------------------------------------------------


def to_gray(img: np.ndarray) -> np.ndarray:
    """(C, H, W) or (H, W) image -> float64 (H, W) grayscale."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = img.mean(axis=0)
    rng = img.max() - img.min()
    return (img - img.min()) / (rng if rng > 0 else 1.0)


def _box_filter(x: np.ndarray, r: int) -> np.ndarray:
    """(2r+1)^2 box sum via an integral image (numpy only, no scipy)."""
    H, W = x.shape
    ii = np.zeros((H + 1, W + 1), np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(x, axis=0), axis=1)
    r0 = np.clip(np.arange(H) - r, 0, H)
    r1 = np.clip(np.arange(H) + r + 1, 0, H)
    c0 = np.clip(np.arange(W) - r, 0, W)
    c1 = np.clip(np.arange(W) + r + 1, 0, W)
    return (
        ii[r1][:, c1] - ii[r0][:, c1] - ii[r1][:, c0] + ii[r0][:, c0]
    )


def harris_corners(
    gray: np.ndarray, n_max: int = 1200, nms_radius: int = 3,
    k: float = 0.05, border: int = 8,
) -> np.ndarray:
    """Top-``n_max`` Harris corners -> (N, 2) float64 (col, row)."""
    gy, gx = np.gradient(gray)
    sxx = _box_filter(gx * gx, 2)
    syy = _box_filter(gy * gy, 2)
    sxy = _box_filter(gx * gy, 2)
    resp = sxx * syy - sxy * sxy - k * (sxx + syy) ** 2

    # non-max suppression: keep strict local maxima over the NMS window
    m = resp.copy()
    for dr in range(-nms_radius, nms_radius + 1):
        for dc in range(-nms_radius, nms_radius + 1):
            if dr == 0 and dc == 0:
                continue
            shifted = np.full_like(resp, -np.inf)
            rs = slice(max(dr, 0), resp.shape[0] + min(dr, 0))
            rd = slice(max(-dr, 0), resp.shape[0] + min(-dr, 0))
            cs = slice(max(dc, 0), resp.shape[1] + min(dc, 0))
            cd = slice(max(-dc, 0), resp.shape[1] + min(-dc, 0))
            shifted[rd, cd] = resp[rs, cs]
            m = np.where(shifted >= m, -np.inf, m)
    m[:border, :] = -np.inf
    m[-border:, :] = -np.inf
    m[:, :border] = -np.inf
    m[:, -border:] = -np.inf

    rows, cols = np.nonzero(np.isfinite(m) & (m > 0))
    if rows.size == 0:
        return np.zeros((0, 2))
    order = np.argsort(m[rows, cols])[::-1][:n_max]
    rows, cols = rows[order], cols[order]

    # sub-pixel refinement: 1D quadratic fit on the response along each
    # axis (integer corners alone cost ~1 px of observation noise, which
    # the small-baseline altitude geometry amplifies ~10x in meters)
    def _subpix(f_m, f_0, f_p):
        den = f_m - 2.0 * f_0 + f_p
        d = np.where(np.abs(den) > 1e-12, 0.5 * (f_m - f_p) / den, 0.0)
        return np.clip(d, -0.5, 0.5)

    dc = _subpix(resp[rows, cols - 1], resp[rows, cols], resp[rows, cols + 1])
    dr = _subpix(resp[rows - 1, cols], resp[rows, cols], resp[rows + 1, cols])
    return np.stack([cols + dc, rows + dr], axis=1).astype(np.float64)


# -----------------------------------------------------------------------
# matching
# -----------------------------------------------------------------------


def _patches(gray: np.ndarray, pts: np.ndarray, half: int) -> np.ndarray:
    """ZNCC-normalised (N, (2h+1)^2) patches at integer corner positions."""
    c = np.round(pts[:, 0]).astype(int)
    r = np.round(pts[:, 1]).astype(int)
    offs = np.arange(-half, half + 1)
    rr = r[:, None, None] + offs[None, :, None]
    cc = c[:, None, None] + offs[None, None, :]
    p = gray[rr, cc].reshape(len(pts), -1)
    p = p - p.mean(axis=1, keepdims=True)
    n = np.linalg.norm(p, axis=1, keepdims=True)
    return p / np.where(n > 1e-12, n, 1.0)


def match_pair(
    gray_a, gray_b, rpc_a: RPCModel, rpc_b: RPCModel,
    corners_a: np.ndarray, corners_b: np.ndarray,
    alt_range: tuple[float, float],
    patch_half: int = 5, zncc_min: float = 0.80, locus_tol: float = 3.0,
    n_alts: int = 16,
) -> np.ndarray:
    """RPC-locus-constrained ZNCC matches -> (M, 2) int (idx_a, idx_b)."""
    if len(corners_a) == 0 or len(corners_b) == 0:
        return np.zeros((0, 2), int)
    alts = np.linspace(alt_range[0], alt_range[1], n_alts)

    # locus of every A corner in B: (N_a, n_alts) cols/rows
    ca = np.repeat(corners_a[:, 0], n_alts)
    ra = np.repeat(corners_a[:, 1], n_alts)
    aa = np.tile(alts, len(corners_a))
    lon, lat = rpc_a.localization(ca, ra, aa)
    lc, lr = rpc_b.projection(lon, lat, aa)
    lc = lc.reshape(len(corners_a), n_alts)
    lr = lr.reshape(len(corners_a), n_alts)

    # distance of each B corner to each A locus (min over altitudes).
    # Fold the min over altitude slices instead of materialising the
    # (N_a, N_b, n_alts) temporaries: at the 1200-corner/16-alt defaults
    # the broadcast form peaks ~0.5 GB per view pair; this is ~23 MB.
    cb = corners_b[:, 0].astype(np.float64)
    rb = corners_b[:, 1].astype(np.float64)
    min_d2 = np.full((len(corners_a), len(corners_b)), np.inf)
    for k in range(n_alts):
        dc = lc[:, k : k + 1] - cb[None, :]
        dr = lr[:, k : k + 1] - rb[None, :]
        np.minimum(min_d2, dc * dc + dr * dr, out=min_d2)
    near = min_d2 <= locus_tol * locus_tol

    pa = _patches(gray_a, corners_a, patch_half)
    pb = _patches(gray_b, corners_b, patch_half)
    zncc = pa @ pb.T
    zncc = np.where(near, zncc, -np.inf)

    best_b = zncc.argmax(axis=1)
    best_a = zncc.argmax(axis=0)
    ia = np.arange(len(corners_a))
    score = zncc[ia, best_b]
    mutual = (best_a[best_b] == ia) & (score >= zncc_min)
    return np.stack([ia[mutual], best_b[mutual]], axis=1)


class _UnionFind:
    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            p = self.parent[x] = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def build_tracks(pair_matches: dict, corners: list) -> list:
    """Union-find over (view, corner) nodes -> [{view: (col, row)}, ...].

    ``pair_matches``: {(i, j): (M, 2) index pairs}. Components containing
    two corners of the SAME view are ambiguous and dropped (standard
    track-building rule).
    """
    uf = _UnionFind()
    for (i, j), m in pair_matches.items():
        for a, b in m:
            uf.union((i, int(a)), (j, int(b)))
    groups: dict = {}
    for node in list(uf.parent):
        groups.setdefault(uf.find(node), []).append(node)
    tracks = []
    for nodes in groups.values():
        views = [v for v, _ in nodes]
        if len(nodes) < 2 or len(set(views)) != len(views):
            continue
        tracks.append(
            {v: tuple(corners[v][ci]) for v, ci in sorted(nodes)}
        )
    return tracks


# -----------------------------------------------------------------------
# triangulation + bias adjustment
# -----------------------------------------------------------------------


def _project_all(
    rpcs: list, lon, lat, alt, bias: np.ndarray | None = None
) -> np.ndarray:
    """(T,) ground points through every view -> (T, V, 2) (col, row)."""
    out = np.zeros((len(lon), len(rpcs), 2))
    for v, rpc in enumerate(rpcs):
        c, r = rpc.projection(lon, lat, alt)
        out[:, v, 0] = c
        out[:, v, 1] = r
    if bias is not None:
        out += bias[None, :, :]
    return out


def _residuals(rpcs, pts, obs, mask, bias):
    proj = _project_all(rpcs, pts[:, 0], pts[:, 1], pts[:, 2], bias)
    return np.where(mask[:, :, None], obs - proj, 0.0)


def triangulate_tracks(
    tracks: list, rpcs: list, alt_range: tuple[float, float],
    n_alts: int = 48,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Altitude-grid init -> (pts (T,3) lon/lat/alt, obs (T,V,2), mask (T,V))."""
    V = len(rpcs)
    T = len(tracks)
    obs = np.zeros((T, V, 2))
    mask = np.zeros((T, V), bool)
    ref = np.zeros(T, int)
    for t, tr in enumerate(tracks):
        for v, (c, r) in tr.items():
            obs[t, v] = (c, r)
            mask[t, v] = True
        ref[t] = min(tr)

    alts = np.linspace(alt_range[0], alt_range[1], n_alts)
    best_err = np.full(T, np.inf)
    best = np.zeros((T, 3))
    for h in alts:
        lon = np.zeros(T)
        lat = np.zeros(T)
        for v in range(V):  # localization of each track's ref-view corner
            sel = ref == v
            if sel.any():
                lo, la = rpcs[v].localization(
                    obs[sel, v, 0], obs[sel, v, 1], np.full(sel.sum(), h)
                )
                lon[sel] = lo
                lat[sel] = la
        pts = np.stack([lon, lat, np.full(T, h)], axis=1)
        r = _residuals(rpcs, pts, obs, mask, None)
        err = (np.linalg.norm(r, axis=2) * mask).sum(1) / mask.sum(1)
        better = err < best_err
        best_err = np.where(better, err, best_err)
        best[better] = pts[better]
    return best, obs, mask


def _gauss_newton_points(
    rpcs, pts, obs, mask, bias, n_iter: int = 4, damping: float = 1e-9
) -> np.ndarray:
    """Damped GN on (lon, lat, alt) per track, vectorised over tracks with
    central-difference Jacobians and batched 3x3 normal equations."""
    steps = np.array([1e-7, 1e-7, 0.05])  # ~1 cm in degrees / 5 cm alt
    for _ in range(n_iter):
        r = _residuals(rpcs, pts, obs, mask, bias)  # (T, V, 2)
        J = np.zeros(r.shape + (3,))
        for k in range(3):
            d = np.zeros(3)
            d[k] = steps[k]
            rp = _residuals(rpcs, pts + d, obs, mask, bias)
            rm = _residuals(rpcs, pts - d, obs, mask, bias)
            J[..., k] = (rp - rm) / (2 * steps[k])
        Jf = J.reshape(len(pts), -1, 3)
        rf = r.reshape(len(pts), -1)
        A = np.einsum("tik,til->tkl", Jf, Jf)
        A += damping * np.eye(3)[None]
        # J is the RESIDUAL Jacobian (r = obs - proj, J = -dproj/dp), so the
        # Gauss-Newton step is dp = -(J^T J)^-1 J^T r
        g = np.einsum("tik,ti->tk", Jf, rf)
        dp = -np.linalg.solve(A, g[..., None])[..., 0]
        pts = pts + dp
    return pts


def bundle_adjust(
    rpcs: list, pts: np.ndarray, obs: np.ndarray, mask: np.ndarray,
    n_rounds: int = 6, outlier_px: float = 2.0, bias_prior: float = 4.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Alternating LS: tracks <-> per-view (d_col, d_row) bias.

    Gauge: a rigid translation of every point along one view's ray is
    invisible to that view and absorbable by the other views' biases, so a
    hard single-view anchor lets the whole point cloud drift. Instead ALL
    views carry a bias with a weak zero prior (``bias_prior`` pseudo-
    observations per view): the solver picks the minimal-norm correction —
    the standard assumption for RPC bias adjustment, where corrections are
    known to be a few pixels. Absolute geolocation remains (as in
    sat-bundleadjust) only as good as the input RPC family's common frame;
    the outputs are self-consistent points + adjusted cameras.

    Returns (pts, obs, bias (V, 2), mask, residuals (T, V)) — pts/obs/
    mask may have FEWER rows than the inputs: tracks fully rejected by
    the outlier pass are dropped (they would otherwise ride through the
    remaining GN rounds as dead work), so consume the returned arrays,
    not the ones passed in."""
    V = len(rpcs)
    bias = np.zeros((V, 2))
    for rnd in range(n_rounds):
        pts = _gauss_newton_points(rpcs, pts, obs, mask, bias)
        r = _residuals(rpcs, pts, obs, mask, bias)
        for v in range(V):
            n_v = int(mask[:, v].sum())
            if n_v:  # ridge-regularised closed-form translation update
                total = r[mask[:, v], v].sum(axis=0) + n_v * bias[v]
                bias[v] = total / (n_v + bias_prior)
        if rnd == 1:  # one outlier-rejection pass after the geometry settles
            res = np.linalg.norm(
                _residuals(rpcs, pts, obs, mask, bias), axis=2
            )
            med = np.median(res[mask]) if mask.any() else 0.0
            keep = res <= max(outlier_px, 3.0 * med)
            mask = mask & keep
            mask[mask.sum(axis=1) < 2] = False  # tracks need >= 2 views
            # drop fully-dead tracks from the arrays: rejected rows would
            # otherwise ride through the remaining GN rounds as pure
            # wasted work (a damped identity solve + V RPC projections
            # per dead track per iteration)
            alive = mask.any(axis=1)
            pts, obs, mask = pts[alive], obs[alive], mask[alive]
    res = np.linalg.norm(_residuals(rpcs, pts, obs, mask, bias), axis=2)
    return pts, obs, bias, mask, res


# -----------------------------------------------------------------------
# orchestration
# -----------------------------------------------------------------------


def run_native_ba(
    names: list, grays: list, rpcs: list, geotiff_paths: list,
    alt_range: tuple[float, float], out_dp: str,
    n_corners: int = 1200, zncc_min: float = 0.80, locus_tol: float = 3.0,
) -> dict:
    """Full native BA over a view set; writes the sat-bundleadjust output
    contract under ``out_dp`` (ba_params/ + rpcs_adj/) and returns stats."""
    V = len(names)
    corners = [harris_corners(g, n_max=n_corners) for g in grays]
    pair_matches: dict = {}
    for i in range(V):
        for j in range(i + 1, V):
            m = match_pair(
                grays[i], grays[j], rpcs[i], rpcs[j], corners[i], corners[j],
                alt_range, zncc_min=zncc_min, locus_tol=locus_tol,
            )
            if len(m):
                pair_matches[(i, j)] = m
    tracks = build_tracks(pair_matches, corners)
    if not tracks:
        raise RuntimeError(
            "native BA found no multi-view tracks; check image texture or "
            "loosen zncc_min/locus_tol"
        )
    pts, obs, mask = triangulate_tracks(tracks, rpcs, alt_range)
    pts, obs, bias, mask, res = bundle_adjust(rpcs, pts, obs, mask)

    keep = mask.sum(axis=1) >= 2
    pts, obs, mask, res = pts[keep], obs[keep], mask[keep], res[keep]

    # ---- write the import contract -----------------------------------
    ba_dp = os.path.join(out_dp, "ba_params")
    adj_dp = os.path.join(out_dp, "rpcs_adj")
    os.makedirs(ba_dp, exist_ok=True)
    os.makedirs(adj_dp, exist_ok=True)

    x, y, z = latlon_to_ecef(pts[:, 1], pts[:, 0], pts[:, 2])
    pts3d = np.stack([x, y, z], axis=1)
    t_idx, v_idx = np.nonzero(mask)
    # observed keypoints corrected INTO the adjusted-camera frame: the
    # adjusted RPC projects pts3d to (proj + bias), and obs ~ proj + bias
    # already (bias was fit to the observations), so obs passes through
    pts2d = obs[t_idx, v_idx]
    np.save(os.path.join(ba_dp, "pts3d.npy"), pts3d)
    np.save(os.path.join(ba_dp, "pts2d.npy"), pts2d)
    np.save(os.path.join(ba_dp, "cam_ind.npy"), v_idx.astype(np.int64))
    np.save(os.path.join(ba_dp, "pts_ind.npy"), t_idx.astype(np.int64))
    with open(os.path.join(ba_dp, "geotiff_paths.txt"), "w") as f:
        f.write("\n".join(geotiff_paths) + "\n")

    import dataclasses

    for v, (name, rpc) in enumerate(zip(names, rpcs)):
        # adjusted camera: projection_adj = projection + bias_v, i.e. the
        # per-view offset folds into the RPC's image-space offsets
        adj = dataclasses.replace(
            rpc,
            col_offset=rpc.col_offset + bias[v, 0],
            row_offset=rpc.row_offset + bias[v, 1],
        )
        adj.to_rpc_file(os.path.join(adj_dp, name + ".rpc_adj"))

    stats = {
        "n_tracks": int(len(pts3d)),
        "n_obs": int(len(pts2d)),
        "bias_px": bias.tolist(),
        "mean_reproj_px": float(res[mask].mean()) if mask.any() else 0.0,
        "median_reproj_px": float(np.median(res[mask])) if mask.any() else 0.0,
    }
    logger.info(
        "DataPrep",
        f"native BA: {stats['n_tracks']} tracks / {stats['n_obs']} obs, "
        f"mean reproj {stats['mean_reproj_px']:.3f} px",
    )
    return stats
