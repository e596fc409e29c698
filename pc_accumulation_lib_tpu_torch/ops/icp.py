"""Point-to-plane ICP ego-motion registration on tensors.

Counterpart of ops/icp.py: fixed-capacity strided subsample, k-NN
covariance normals (closed-form smallest eigenvector), and a fixed number
of Gauss-Newton steps with an annealed trim. ``register(source, target)``
returns T mapping source-frame coords to target-frame coords.

Every product is in the clouds' dtype: float32 on the accumulators'
paths; a float64 run of the same code is the reference that float32
rounding is measured against. Nothing here syncs with the host: the 6x6
solve is ``torch.linalg.solve_ex`` without the error check, and the
degenerate-step guard is a ``torch.where``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ICPCloud(NamedTuple):
    """Fixed-capacity downsampled cloud with normals."""
    points: torch.Tensor    # (M,3)
    normals: torch.Tensor   # (M,3)
    valid: torch.Tensor     # (M,) bool


def strided_subsample(points, valid, max_out):
    """``max_out`` evenly spaced valid points (indices floor(i*n/M)) of a
    prefix-packed padded cloud; repeats points when n < M."""
    n = valid.sum()
    idx = (torch.arange(max_out, device=points.device) * n) // max_out
    idx = idx.clamp(0, points.shape[0] - 1)
    return points[idx], (n > 0).expand(max_out)


def _pairwise_sqdist(a, b, b_valid):
    """(Na,Nb) squared distances; invalid b columns -> +inf."""
    d2 = ((a * a).sum(1)[:, None] - 2.0 * (a @ b.T)
          + (b * b).sum(1)[None, :])
    return torch.where(b_valid[None, :], d2, math.inf)


def _det3(B):
    """Determinant of (...,3,3) by cofactors."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def _smallest_eigvec_sym3(A):
    """Smallest eigenvector of symmetric (...,3,3) matrices: trigonometric
    (Cardano) eigenvalue, then the largest cross product of two rows of
    (A - lambda_min I). Isotropic neighbourhoods fall back to +z."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    B = A - q * eye
    p2 = (B * B).sum((-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp(min=1e-30))
    r = (_det3(B) / (2.0 * p ** 3)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q[..., 0, 0] + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    C = A - lam_min[..., None, None] * eye
    cands = torch.stack([torch.linalg.cross(C[..., 0, :], C[..., 1, :]),
                         torch.linalg.cross(C[..., 0, :], C[..., 2, :]),
                         torch.linalg.cross(C[..., 1, :], C[..., 2, :])],
                        dim=-2)
    best = (cands * cands).sum(-1).argmax(-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    ok = torch.sqrt((v * v).sum(-1, keepdim=True)) > 1e-20
    v = torch.where(ok, v, eye[2])
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _knn_indices(d2, k):
    """(M,k) nearest-neighbour indices by k argmin sweeps; ties take the
    first index, as jnp.argmin does."""
    d2 = d2.clone()   # masked in place below
    idxs = []
    for _ in range(k):
        i = torch.argmin(d2, dim=1)
        idxs.append(i)
        d2.scatter_(1, i[:, None], math.inf)
    return torch.stack(idxs, dim=1)


def estimate_normals(points, valid, k=10):
    """k-NN covariance normals (smallest eigenvector per point)."""
    idx = _knn_indices(_pairwise_sqdist(points, points, valid), k)
    nbrs = points[idx]                                   # (M,k,3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum('mki,mkj->mij', centered, centered) / k
    return _smallest_eigvec_sym3(cov)


def _so3_hat(w):
    zero = torch.zeros_like(w[0])
    return torch.stack([torch.stack([zero, -w[2], w[1]]),
                        torch.stack([w[2], zero, -w[0]]),
                        torch.stack([-w[1], w[0], zero])])


def se3_exp(delta):
    """SE(3) exponential of delta = [omega(3), v(3)] -> (4,4), with Taylor
    guards near theta = 0."""
    omega, v = delta[:3], delta[3:]
    theta = torch.linalg.vector_norm(omega)
    K = _so3_hat(omega)
    t2 = theta * theta
    small = theta < 1e-6
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - t2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, t2))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, t2 * theta))
    KK = K @ K
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    R = eye + a * K + b * KK
    V = eye + b * K + c * KK
    T = torch.eye(4, dtype=delta.dtype, device=delta.device)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def make_register_fn(num_iters=12, damping=1e-6, trim_ratio=0.9):
    """Point-to-plane registration fn(source, target, T_init (4,4),
    max_corr_dist) -> (T, rmse, n_corr). The worst (1-trim_ratio)
    correspondences are dropped from iteration num_iters//2 on."""

    def step(T, it, src, tgt, max_corr_dist):
        p = src.points @ T[:3, :3].T + T[:3, 3]
        d2 = _pairwise_sqdist(p, tgt.points, tgt.valid)
        nn = torch.argmin(d2, dim=1)            # first index on ties
        nn_d2 = d2.gather(1, nn[:, None])[:, 0]
        q = tgt.points[nn]
        n = tgt.normals[nn]
        w = (src.valid & (nn_d2 < max_corr_dist ** 2)).to(p.dtype)
        if trim_ratio < 1.0 and it >= num_iters // 2:
            finite_d2 = torch.where(w > 0, nn_d2, math.nan)
            cutoff = torch.nanquantile(finite_d2, trim_ratio)
            w = torch.where(nn_d2 > cutoff, 0.0, w)
        r = ((p - q) * n).sum(1)
        J = torch.cat([torch.linalg.cross(p, n), n], dim=1)      # (M,6)
        Jw = J * w[:, None]
        H = Jw.T @ J + damping * torch.eye(6, dtype=J.dtype, device=J.device)
        g = Jw.T @ r
        delta = -torch.linalg.solve_ex(H, g)[0]
        T_new = se3_exp(delta) @ T
        n_corr = w.sum()
        rmse = torch.sqrt((w * r * r).sum() / n_corr.clamp(min=1.0))
        T_new = torch.where(n_corr >= 6, T_new, T)   # degenerate: hold T
        return T_new, rmse, n_corr

    def register(source: ICPCloud, target: ICPCloud, T_init, max_corr_dist):
        T = T_init.to(source.points.dtype)
        rmse = n_corr = None
        for it in range(num_iters):
            T, rmse, n_corr = step(T, it, source, target, max_corr_dist)
        return T, rmse, n_corr

    return register


def make_coarse_to_fine_register_fn(num_iters=16, damping=1e-6,
                                    trim_ratio=0.9, coarse_factor=8,
                                    coarse_iters=10):
    """A coarse solve on strided sub-clouds seeds the full-resolution
    solve. Same signature as make_register_fn's fn."""
    coarse = make_register_fn(coarse_iters, damping, trim_ratio)
    fine = make_register_fn(num_iters, damping, trim_ratio)

    def strided(c: ICPCloud) -> ICPCloud:
        return ICPCloud(points=c.points[::coarse_factor],
                        normals=c.normals[::coarse_factor],
                        valid=c.valid[::coarse_factor])

    def register(source: ICPCloud, target: ICPCloud, T_init, max_corr_dist):
        T0, _, _ = coarse(strided(source), strided(target), T_init,
                          max_corr_dist)
        return fine(source, target, T0, max_corr_dist)

    return register


def make_preprocess_fn(max_out, normal_k=10):
    """Cloud preprocess fn: raw padded (N,>=3) + valid -> ICPCloud
    (strided subsample + k-NN covariance normals)."""

    def preprocess(points, valid):
        sub, v = strided_subsample(points[:, :3], valid, max_out)
        return ICPCloud(points=sub, normals=estimate_normals(sub, v,
                                                             k=normal_k),
                        valid=v)

    return preprocess
