"""Core geometry ops on tensors: rigid transforms, camera projection, point
painting, BEV view-frame mapping.

Counterpart of ops/geometry.py. Every product stays in float32 (the JAX
package runs them at Precision.HIGHEST); on a CUDA device that needs
``torch.backends.cuda.matmul.allow_tf32 == False``, PyTorch's default.
Indices are clipped and float values clamped before every integer cast or
gather: XLA clamps out-of-range gathers and saturates float->int casts,
CUDA does neither.
"""
from __future__ import annotations

import numpy as np
import torch


def rotation_matrix_z(ang):
    """3x3 rotation about +z for a 0-d angle tensor."""
    c, s = torch.cos(ang), torch.sin(ang)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero]),
                        torch.stack([s, c, zero]),
                        torch.stack([zero, zero, one])])


def rigid_inverse(T):
    """Exact inverse of a rigid (4,4) transform: (R^T, -R^T t)."""
    R, t = T[:3, :3], T[:3, 3]
    # Built from device tensors only: assigning a Python scalar into a
    # CUDA tensor would be a synchronous host->device copy.
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = R.T
    out[:3, 3] = -(R.T @ t)
    return out


def homo_transform(T, points):
    """Apply a (4,4) homogeneous transform to (N,3) points: R x + t."""
    return points @ T[:3, :3].T + T[:3, 3]


def velo2frame(points, P_velo_frame):
    """(N,3) velodyne coords -> (N,3) image-frame coords via (3,4) P."""
    return points @ P_velo_frame[:, :3].T + P_velo_frame[:, 3]


def project_to_image(points, P_velo_frame, img_h, img_w):
    """Project (N,3) velodyne points to rounded pixel coords.

    Returns (u, v, mask): int32 pixel coords and the in-image, in-front
    mask. Exact zero depths are nudged to -1e-6 like the reference, which
    makes u, v huge; they are clamped to [-1, size] in float before the
    cast, which keeps the mask identical to the saturating XLA cast."""
    frame = velo2frame(points, P_velo_frame)
    depth = frame[:, 2]
    safe_depth = torch.where(depth == 0.0, -1e-6, depth)
    abs_depth = torch.abs(safe_depth)
    u = torch.round(frame[:, 0] / abs_depth).clamp(-1, img_w).to(torch.int32)
    v = torch.round(frame[:, 1] / abs_depth).clamp(-1, img_h).to(torch.int32)
    mask = ((u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
            & (depth > 0.0))
    return u, v, mask


def paint_from_image(points, P_velo_frame, feature_map):
    """Gather per-point features (H,W,K) by projection. Returns (feats
    (N,K), garbage where mask is False; mask (N,))."""
    img_h, img_w = feature_map.shape[0], feature_map.shape[1]
    u, v, mask = project_to_image(points, P_velo_frame, img_h, img_w)
    ui = u.clamp(0, img_w - 1).to(torch.int64)
    vi = v.clamp(0, img_h - 1).to(torch.int64)
    return feature_map[vi, ui], mask


def semseg_filter_mask(sem, filters):
    """True for points whose semantic class is not in ``filters``."""
    mask = torch.ones(sem.shape, dtype=torch.bool, device=sem.device)
    for f in filters:
        mask &= sem != f
    return mask


def geometric_transform(xyz, rot_ang, trans_dx, trans_dy):
    """Rotate about z, then translate in xy (0-d tensor parameters)."""
    out = xyz @ rotation_matrix_z(rot_ang).T
    shift = torch.stack([trans_dx, trans_dy, torch.zeros_like(trans_dx)])
    return out + shift


def crop_view_mask(xyz, view_size):
    """Strict open-interval view-frame crop."""
    half = 0.5 * view_size
    return ((xyz[:, 0] > -half) & (xyz[:, 0] < half)
            & (xyz[:, 1] > -half) & (xyz[:, 1] < half))


def pos2grid(xy, view_size, pixel_size):
    """Metric xy -> pixel coords floor(x/view*P + P/2), as float."""
    return torch.floor(xy / view_size * pixel_size + 0.5 * pixel_size)


def grid_cell_index(px, py, pixel_size):
    """Flat raster cell id, row = P-1-y (image flip). Pixel coords of
    masked rows may be wild: they are clamped to [-1, P] in float first,
    which leaves every in-range id unchanged."""
    P = pixel_size
    row = P - 1 - py.clamp(-1, P).to(torch.int32)
    col = px.clamp(-1, P).to(torch.int32)
    return row * P + col


def heading_rot_ang(ego_traj_present) -> float:
    """Heading-aligned BEV rotation angle, the one applied when no random
    augmentation is drawn: the last present ego segment of the (N,3)
    trajectory points up in the BEV; pi/2 when N < 2 or the trajectory is
    None. On the host."""
    rot_ang = 0.5 * np.pi
    if ego_traj_present is not None and len(ego_traj_present) > 1:
        dx = ego_traj_present[-1][0] - ego_traj_present[-2][0]
        dy = ego_traj_present[-1][1] - ego_traj_present[-2][1]
        rot_ang += np.arctan2(dy, dx)
    return float(np.pi - rot_ang)
