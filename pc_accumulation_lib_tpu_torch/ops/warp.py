"""Polynomial BEV warping augmentation.

Counterpart of ops/warp.py: the numpy host helpers (warp parameter draws,
the trajectory warp, and the dense map warp the sparse fetch applies after
its decode) and the dense map warp on tensors, a separable gather with
per-axis source-index maps.
"""
from __future__ import annotations

import numpy as np
import torch


def cal_warp_params(idx_0, idx_1, idx_max):
    """Quadratic warp coefficients (a_1, a_2) through (0,0), (idx_max,
    idx_max) and (idx_0, idx_1)."""
    a_1 = (idx_1 - idx_0**2 / idx_max) / (idx_0 * (1.0 - idx_0 / idx_max))
    a_2 = (1.0 - a_1) / idx_max
    return a_1, a_2


def get_random_warp_params(mean_ratio, max_ratio, I, J, rng):
    """Random warp anchor (i_warp, j_warp) from a numpy Generator:
    |N(mean, max)| clipped to max, random sign, offset from the middle.
    Draws in the same order as the JAX package, so one seed gives the same
    anchors."""
    max_val = max_ratio * (I / 2.0)
    mean_val = mean_ratio * max_val
    i_warp = rng.normal(mean_val, max_val)
    j_warp = rng.normal(mean_val, max_val)
    if abs(i_warp) > max_val:
        i_warp = max_val
    if abs(j_warp) > max_val:
        j_warp = max_val
    if rng.random() < 0.5:
        i_warp = -i_warp
    if rng.random() < 0.5:
        j_warp = -j_warp
    return (int(I / 2) + i_warp, int(J / 2) + j_warp)


def _poly_index_map(a_1, a_2, n):
    """Source index for each destination index: clip(rint(a1*k + a2*k^2))
    with 0-d tensor coefficients; clamped in float before the cast."""
    k = torch.arange(n, dtype=torch.float32, device=a_1.device)
    src = torch.round(a_1 * k + a_2 * k * k)
    return src.clamp(0, n - 1).to(torch.int64)


def warp_dense_maps(maps, a_1, a_2, b_1, b_2):
    """Warp a stack of dense maps (C,I,J): B[:, jw, iw] = A[:, j(jw),
    i(iw)], rows from the b-params and columns from the a-params."""
    n_rows, n_cols = maps.shape[-2], maps.shape[-1]
    rows = _poly_index_map(b_1, b_2, n_rows)
    cols = _poly_index_map(a_1, a_2, n_cols)
    return maps.index_select(-2, rows).index_select(-1, cols)


def warp_index_maps_np(a_1, a_2, b_1, b_2, n_rows, n_cols):
    """Host (numpy) source-index maps of the dense warp: (rows from the
    b-params, columns from the a-params), int32, clip(rint(a1*k +
    a2*k^2)) in float32 as warp_dense_maps computes them."""
    def idx_map(a1, a2, n):
        k = np.arange(n, dtype=np.float32)
        src = np.rint(np.float32(a1) * k
                      + np.float32(a2) * k * k).astype(np.int32)
        return np.clip(src, 0, n - 1)
    return idx_map(b_1, b_2, n_rows), idx_map(a_1, a_2, n_cols)


def warp_dense_maps_np(maps, a_1, a_2, b_1, b_2):
    """Host twin of warp_dense_maps on a numpy (..., I, J) stack: the
    sparse fetch ships maps before the warp (the warp duplicates cells),
    and the host warps after the decode. One flat gather."""
    n_rows, n_cols = maps.shape[-2], maps.shape[-1]
    ri, ci = warp_index_maps_np(a_1, a_2, b_1, b_2, n_rows, n_cols)
    flat = (ri[:, None] * n_cols + ci[None, :]).reshape(-1)
    lead = maps.shape[:-2]
    out = maps.reshape(lead + (n_rows * n_cols,))[..., flat]
    return out.reshape(lead + (n_rows, n_cols))


def _inverse_quadratic(x, a_1, a_2):
    """Closed-form inverse of y = a1*x + a2*x^2 (degenerate-case guard as
    the reference)."""
    x = np.asarray(x, np.float64)
    disc = a_1 * a_1 + 4.0 * a_2 * x
    inv = np.rint((-a_1 + np.sqrt(np.maximum(disc, 0.0)))
                  / (2.0 * a_2 + 1e-30))
    return np.where(abs(a_2) < 1e-6, x, inv)


def warp_points_xy(x, y, a_1, a_2, b_1, b_2, I, J):
    """Inverse-warp point coordinates: x by the a-params, y by the
    b-params, int-rounded and clipped to [0, I-1] and [0, J-1]. Host
    numpy; returns (xw, yw) float64."""
    xw = np.clip(_inverse_quadratic(x, a_1, a_2), 0, I - 1)
    yw = np.clip(_inverse_quadratic(y, b_1, b_2), 0, J - 1)
    return xw, yw


def warp_sparse_points(pnts, a_1, a_2, j_mid, j_warp, pixel_size):
    """Warp (N,>=2) pixel-coordinate points: x by the a-params, y by
    b-params recomputed from the reversed j anchor (the reference's axis
    flip), int-rounded and clipped."""
    b_1_rev, b_2_rev = cal_warp_params(pixel_size - j_warp, j_mid,
                                       pixel_size - 1)
    out = np.asarray(pnts).copy()
    out[:, 0], out[:, 1] = warp_points_xy(out[:, 0], out[:, 1], a_1, a_2,
                                          b_1_rev, b_2_rev, pixel_size,
                                          pixel_size)
    return out


def warp_trajs(trajs, a_1, a_2, j_mid, j_warp, pixel_size):
    """Warp a list of (N,3) pixel-space trajectories."""
    return [warp_sparse_points(t, a_1, a_2, j_mid, j_warp, pixel_size)
            if t.shape[0] > 0 else t for t in trajs]
