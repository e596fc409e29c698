"""Trajectory view-frame cropping with edge interpolation.

Reference: BEVGenerator.crop_trajectory (bev_generator.py:257-371) walks
consecutive trajectory edges, keeps inside points, and finds box-boundary
crossings with an iterative midpoint bisection to 1e-4 accuracy. Here the
crossing is the closed-form Liang-Barsky segment/box intersection — exact,
so it agrees with the reference within its own bisection threshold (SURVEY.md
hard part 5).

Trajectories are tiny (tens-to-hundreds of poses) host-side lists of
variable-length (N,3) arrays — this stays numpy on host by design (SURVEY.md
section 7 decision 8); only rasters live on device.
"""
from __future__ import annotations

import numpy as np


def point_in_box(x, y, bx0, by0, bx1, by1):
    """Strict interior test (bev_generator.py:317-320)."""
    return (bx0 < x < bx1) and (by0 < y < by1)


def _box_intersection(x_in, y_in, x_out, y_out, bbox):
    """Closed-form intersection of the segment (inside -> outside point) with
    the box boundary. Replaces the bisection of cal_intersec_pnt
    (bev_generator.py:322-371)."""
    bx0, by0, bx1, by1 = bbox
    dx = x_out - x_in
    dy = y_out - y_in
    t = 1.0
    if dx > 0:
        t = min(t, (bx1 - x_in) / dx)
    elif dx < 0:
        t = min(t, (bx0 - x_in) / dx)
    if dy > 0:
        t = min(t, (by1 - y_in) / dy)
    elif dy < 0:
        t = min(t, (by0 - y_in) / dy)
    # Land strictly INSIDE the box by ~1e-6 m: the reference's bisection
    # terminates within 1e-4 of the edge, and downstream pos2grid floors —
    # an exact-on-edge point would round into the out-of-raster pixel.
    seg_len = max((dx * dx + dy * dy) ** 0.5, 1e-12)
    t = max(t - 1e-6 / seg_len, 0.0)
    return x_in + t * dx, y_in + t * dy


def crop_trajectory(traj, view_size):
    """Crop a (N,3) trajectory to the view box with edge interpolation.

    Faithful to crop_trajectory (bev_generator.py:257-315) including its
    quirks: the final pose is only emitted via an intersection (the loop runs
    over edges and appends edge start points), and intersection points carry
    the z of the edge's first point.
    """
    half = 0.5 * view_size
    bbox = (-half, -half, half, half)
    new_traj = []
    for idx in range(traj.shape[0] - 1):
        x0, y0, z0 = float(traj[idx, 0]), float(traj[idx, 1]), float(traj[idx,
                                                                         2])
        x1, y1 = float(traj[idx + 1, 0]), float(traj[idx + 1, 1])
        p0_in = point_in_box(x0, y0, *bbox)
        p1_in = point_in_box(x1, y1, *bbox)
        if not p0_in and not p1_in:
            continue
        elif p0_in and p1_in:
            new_traj.append([x0, y0, z0])
        elif p0_in and not p1_in:
            new_traj.append([x0, y0, z0])
            ix, iy = _box_intersection(x0, y0, x1, y1, bbox)
            new_traj.append([ix, iy, z0])
        else:  # not p0_in and p1_in
            ix, iy = _box_intersection(x1, y1, x0, y0, bbox)
            new_traj.append([ix, iy, z0])
    if len(new_traj) == 0:
        return np.zeros((0, 3))
    return np.array(new_traj)


def geometric_transform_traj(traj, rot_ang, trans_dx, trans_dy, view_size):
    """Host-side trajectory version of BEVGenerator.geometric_transform
    (bev_generator.py:207-237): rotate about z, translate xy, crop with
    interpolation."""
    if traj.shape[0] == 0:
        return np.zeros((0, 3))
    c, s = np.cos(rot_ang), np.sin(rot_ang)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    out = np.asarray(traj, dtype=np.float64).copy()
    out[:, :3] = out[:, :3] @ rot.T
    out[:, 0] += trans_dx
    out[:, 1] += trans_dy
    return crop_trajectory(out, view_size)


def pos2grid_traj(traj, view_size, pixel_size):
    """Metric -> pixel coords for trajectories (bev_generator.py:737-747)."""
    out = np.asarray(traj, dtype=np.float64).copy()
    if out.shape[0] > 0:
        out[:, 0:2] = np.floor(out[:, 0:2] / view_size * pixel_size +
                               0.5 * pixel_size)
    return out
