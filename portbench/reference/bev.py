"""A plain semantic BEV sample: direct binning of points into the raster
cells, and the trajectories' crop and pixel coordinates. Written from the
sample's definition, in float64 (the reference) or in float32 with TF32
matmul operands (the control).

A sample sees the world from ``origin`` (the present ego position),
rotated by ``rot_ang`` about z: a point p goes to t = R(rot_ang) (p -
origin). It is in view when |t_x| and |t_y| are under half the view size
(strictly); its cell is column floor(t_x / view * P + P / 2) and row P -
1 - floor(t_y / view * P + P / 2). Points of an instance flagged dynamic
are left out. Three time splits: 'present' (frames before the present
frame), 'future' (the present frame on) and 'full'. Per split and cell,
seven maps:

  road       (roads + 1) / (points + 2), roads = points of class road;
  intensity  the road points' summed intensity / (roads + 1), then
             min(scaler * sigmoid(sep * (x - mid)), 1);
  r, g, b    the median of the points' integer colour values (the mean of
             the two middle ones for an even count) / 255, 0 if empty;
  dynamic    (dyn + 1) / (points + 2), dyn = points of a vehicle class;
  elevation  the lowest t_z, 0 if empty;

returned as float16 maps under the keys '<map>_<split>' (rgb as one
(3, P, P) array), as the program's samples carry them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ROAD = 0
VEHICLES = (13, 14, 15, 17)    # car, truck, bus, motorcycle


def tf32(x):
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits (to
    nearest, ties away), the operand precision of a TF32 matmul."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def matmul(a, b, control: bool):
    return tf32(a) @ tf32(b) if control else a @ b


def rot_z(ang: float, dtype, device):
    c, s = math.cos(ang), math.sin(ang)
    return torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


def _cell_stats(cell, n_cells, w=None):
    out = torch.zeros(n_cells, dtype=torch.float64, device=cell.device)
    return out.index_add_(0, cell, torch.ones_like(cell, dtype=torch.float64)
                          if w is None else w.to(torch.float64))


def _median(cell, vals, n_cells):
    """Per-cell median of integer values in [0, 255]: sort by (cell,
    value), take the middle one or two of each cell's run; 0 if empty."""
    out = torch.zeros(n_cells, dtype=torch.float64, device=cell.device)
    if cell.numel() == 0:
        return out
    v = torch.sort(cell * 256 + vals).values % 256
    cnt = torch.bincount(cell, minlength=n_cells)
    start = torch.cumsum(cnt, 0) - cnt
    has = cnt > 0
    lo = start[has] + torch.div(cnt[has] - 1, 2, rounding_mode='floor')
    hi = start[has] + cnt[has] // 2
    out[has] = 0.5 * (v[lo] + v[hi]).to(torch.float64)
    return out


def split_maps(cell, t_z, sem, inten, rgb, P, bev):
    """The seven (P, P) float64 maps of one split's points."""
    n = P * P
    road = sem == ROAD
    veh = torch.zeros_like(road)
    for c in VEHICLES:
        veh |= sem == c
    count = _cell_stats(cell, n)
    roads = _cell_stats(cell[road], n)
    road_map = (roads + 1) / (count + 2)
    raw = _cell_stats(cell[road], n, inten[road]) / (roads + 1)
    inten_map = torch.clamp(bev['int_scaler'] * torch.sigmoid(
        bev['int_sep_scaler'] * (raw - bev['int_mid_threshold'])), max=1.0)
    colours = [_median(cell, rgb[:, k].to(torch.int64).clamp(0, 255), n)
               / 255.0 for k in range(3)]
    dyn_map = (_cell_stats(cell[veh], n) + 1) / (count + 2)
    low = torch.full((n,), math.inf, dtype=torch.float64, device=cell.device)
    low.scatter_reduce_(0, cell, t_z.to(torch.float64), reduce='amin')
    elev = torch.where(count > 0, low, 0.0)
    return [m.reshape(P, P) for m in (road_map, inten_map, *colours,
                                      dyn_map, elev)]


def sample_maps(xyz, frame, sem, inten, rgb, dynamic, origin, rot_ang,
                present_frame, bev, control=False):
    """One sample's maps ({'<map>_<split>': float16 array}) from the
    points' world xyz (N, 3), frame ids, classes, intensities, colours
    (N, 3) and dynamic flags."""
    P, view = int(bev['pixel_size']), float(bev['view_size'])
    R = rot_z(rot_ang, xyz.dtype, xyz.device)
    t = matmul(xyz - origin, R.T, control)
    half = 0.5 * view
    keep = ((t[:, 0] > -half) & (t[:, 0] < half) & (t[:, 1] > -half)
            & (t[:, 1] < half) & ~dynamic)
    col = torch.floor(t[:, 0] / view * P + 0.5 * P).to(torch.int64)
    row = P - 1 - torch.floor(t[:, 1] / view * P + 0.5 * P).to(torch.int64)
    cell = (row * P + col).clamp(0, P * P - 1)
    present = frame < present_frame
    out = {}
    for name, m in (('present', keep & present), ('future', keep & ~present),
                    ('full', keep)):
        road, it, r, g, b, dyn, elev = split_maps(
            cell[m], t[m, 2], sem[m], inten[m], rgb[m], P, bev)
        for key, arr in (('road', road), ('intensity', it),
                         ('rgb', torch.stack([r, g, b])),
                         ('dynamic', dyn), ('elevation', elev)):
            out[f'{key}_{name}'] = arr.to(torch.float16).cpu().numpy()
    return out


# ----------------------------------------------------------------------
# Trajectories (host, float64)


def heading_angle(ego_present) -> float:
    """The rotation that points the last present ego segment up in the
    BEV (pi/2 for a straight drive along +x): pi/2 - its heading, and pi/2
    with fewer than two present poses."""
    if ego_present is None or len(ego_present) < 2:
        return 0.5 * math.pi
    dx = ego_present[-1][0] - ego_present[-2][0]
    dy = ego_present[-1][1] - ego_present[-2][1]
    return math.pi - (0.5 * math.pi + math.atan2(dy, dx))


def _inside(x, y, half):
    return -half < x < half and -half < y < half


def _crossing(inside, outside, half):
    """Where the segment from an inside point to an outside one leaves the
    box, taken 1e-6 m short of the edge (so it falls in the edge pixel)."""
    (x0, y0), (x1, y1) = inside, outside
    dx, dy = x1 - x0, y1 - y0
    s = 1.0
    for d, p in ((dx, x0), (dy, y0)):
        if d > 0:
            s = min(s, (half - p) / d)
        elif d < 0:
            s = min(s, (-half - p) / d)
    s = max(s - 1e-6 / max(math.hypot(dx, dy), 1e-12), 0.0)
    return x0 + s * dx, y0 + s * dy


def crop(traj, view):
    """The trajectory's part in the view box: each edge whose start is in
    the box gives its start, and an edge that crosses the box's boundary
    gives the crossing (with the edge start's z); the last pose is not
    given by itself."""
    half = 0.5 * view
    out = []
    for (x0, y0, z0), (x1, y1, _) in zip(traj[:-1], traj[1:]):
        a, b = _inside(x0, y0, half), _inside(x1, y1, half)
        if a:
            out.append((x0, y0, z0))
            if not b:
                out.append((*_crossing((x0, y0), (x1, y1), half), z0))
        elif b:
            out.append((*_crossing((x1, y1), (x0, y0), half), z0))
    return np.array(out, np.float64).reshape(-1, 3)


def traj_pixels(traj, rot_ang, view, P):
    """A metric (N, 3) trajectory, rotated, cropped and in pixel
    coordinates floor(x / view * P + P / 2) (z kept)."""
    traj = np.asarray(traj, np.float64).reshape(-1, 3)
    if traj.shape[0] == 0:
        return np.zeros((0, 3))
    c, s = math.cos(rot_ang), math.sin(rot_ang)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    out = crop(traj @ rot.T, view)
    out[:, :2] = np.floor(out[:, :2] / view * P + 0.5 * P)
    return out
