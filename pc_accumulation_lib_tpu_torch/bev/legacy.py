"""Legacy functional BEV pipeline.

Counterpart of bev/legacy.py, the class-based generator's predecessor: a
past/future split (not present/future/full) with channels the class
pipeline lacks (the sidewalk probmap, the mean elevation with a
lidar-height fill, the per-point sigmoid mean intensity and a rescaled
p(dynamic)), RGB medians filled with 255, and a warp on every sample.

gen_view, gen_aug_view and viz_bev keep the JAX package's signatures
(plus ``device``). The 14 maps are scatter rasters (ops/rasterize.py) on
the device; the augmentation and warp draws stay on the host's numpy
generator in the JAX package's order, so one seed gives both packages the
same sample.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch.ops import geometry as geo
from pc_accumulation_lib_tpu_torch.ops import rasterize as ras
from pc_accumulation_lib_tpu_torch.ops import trajectory as traj_ops
from pc_accumulation_lib_tpu_torch.ops import warp as warp_ops

ROAD_SEM, SIDEWALK_SEM = 0, 1
DYNAMIC_SEMS = (13, 14, 15, 17)  # car, truck, bus, motorcycle
LIDAR_HEIGHT_FROM_GROUND = 1.7

_KEYS = ('gridmap_past_road', 'gridmap_past_sidewalk', 'gridmap_future_road',
         'gridmap_dynamic', 'elevmap_past_mean', 'elevmap_dynamic_mean',
         'intensitymap_past_mean', 'intensitymap_future_mean',
         'red_map_past', 'green_map_past', 'blue_map_past', 'red_map_future',
         'green_map_future', 'blue_map_future')


def _mean_map(cells, mask, values, P, fill):
    """Per-cell mean of ``values``, ``fill`` where a cell is empty."""
    s = ras.count_map(cells, mask, P, weights=values)
    c = ras.count_map(cells, mask, P)
    return torch.where(c == 0, fill, s / (c + 1e-14))


def _prep(pc, rot_ang, dx, dy, aug_view, P):
    """Augmented xyz, the view mask and the clamped cell ids of (N, >=8)
    point rows."""
    xyz = geo.geometric_transform(pc[:, :3], rot_ang, dx, dy)
    m = geo.crop_view_mask(xyz, aug_view)
    grid = geo.pos2grid(xyz[:, :2], aug_view, P)
    cells = geo.grid_cell_index(grid[:, 0], grid[:, 1], P).clamp(
        0, P * P - 1)
    return xyz, m, cells


def _int_map(cells, mask, inten, P):
    """Mean over a cell of the per-point sigmoid intensity, clipped at 1."""
    tr = 4.0 * torch.sigmoid(20.0 * (inten - 0.5))
    return torch.clamp(_mean_map(cells, mask, tr, P, 0.0), max=1.0)


def _gen_view_maps(pc_past, pc_future, rot_ang, dx, dy, aug_view, P,
                   a_1, a_2, b_1, b_2):
    """The 14 channels of _KEYS, warped, as a (14,P,P) float16 stack.
    Point rows (N, >=8) [x, y, z, i, r, g, b, sem]; the scalars are 0-d
    float32 tensors on the rows' device."""
    xyz_p, m_p, cells_p = _prep(pc_past, rot_ang, dx, dy, aug_view, P)
    xyz_f, m_f, cells_f = _prep(pc_future, rot_ang, dx, dy, aug_view, P)
    sem_p, sem_f = pc_past[:, 7], pc_future[:, 7]
    dyn_p = ras.sem_class_mask(sem_p, DYNAMIC_SEMS)
    dyn_f = ras.sem_class_mask(sem_f, DYNAMIC_SEMS)
    stat_p, stat_f = m_p & ~dyn_p, m_f & ~dyn_f
    road_p = ras.sem_class_mask(sem_p, [ROAD_SEM])
    road_f = ras.sem_class_mask(sem_f, [ROAD_SEM])
    sidew_p = ras.sem_class_mask(sem_p, [SIDEWALK_SEM])

    rgb_p = ras.rgb_median_maps(cells_p, stat_p, pc_past[:, 4:7], P,
                                fill_value=255) / 255.0
    rgb_f = ras.rgb_median_maps(cells_f, stat_f, pc_future[:, 4:7], P,
                                fill_value=255) / 255.0
    ground = -LIDAR_HEIGHT_FROM_GROUND
    elev_p = _mean_map(cells_p, stat_p, xyz_p[:, 2], P, ground)
    elev_dyn = _mean_map(cells_p, m_p & dyn_p, xyz_p[:, 2], P, ground)
    int_p = _int_map(cells_p, stat_p & road_p, pc_past[:, 3], P)
    int_f = _int_map(cells_f, stat_f & road_f, pc_future[:, 3], P)

    pm_road_p = ras.sem_probmap(cells_p, stat_p, road_p, P)
    pm_side_p = ras.sem_probmap(cells_p, stat_p, sidew_p, P)
    pm_road_f = ras.sem_probmap(cells_f, stat_f, road_f, P)
    # p(dynamic) against the static points, rescaled from [0.5, 1] to
    # [0, 1]; the dynamic elevation is dropped where it is below 0.1.
    pm_dyn = ras.dirichlet_probmap(ras.count_map(cells_p, m_p & dyn_p, P),
                                   ras.count_map(cells_p, stat_p, P))
    pm_dyn = (torch.clamp(pm_dyn, min=0.5) - 0.5) * 2.0
    elev_dyn = torch.where(pm_dyn < 0.1, ground, elev_dyn)

    maps = torch.stack([
        pm_road_p, pm_side_p, pm_road_f, pm_dyn, elev_p, elev_dyn, int_p,
        int_f, rgb_p[0], rgb_p[1], rgb_p[2], rgb_f[0], rgb_f[1], rgb_f[2]])
    return warp_ops.warp_dense_maps(maps, a_1, a_2, b_1, b_2).to(
        torch.float16)


def _poses_to_grid(poses, rot_ang, dx, dy, aug_view, P, a_1, a_2, j_mid,
                   j_warp):
    """Host poses: transform, crop like points (no edge interpolation),
    pixelize and warp."""
    t = np.asarray(poses, np.float64).reshape(-1, 3)
    c, s = np.cos(rot_ang), np.sin(rot_ang)
    t = t @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]).T
    t[:, 0] += dx
    t[:, 1] += dy
    half = 0.5 * aug_view
    t = t[(np.abs(t[:, 0]) < half) & (np.abs(t[:, 1]) < half)]
    t = traj_ops.pos2grid_traj(t, aug_view, P)
    if t.shape[0]:
        t = warp_ops.warp_sparse_points(t, a_1, a_2, j_mid, j_warp, P)
    return t


@torch.no_grad()
def gen_view(pc_past, pc_future, poses_past, poses_future, rot_ang,
             trans_dx, trans_dy, zoom_scalar, view_size, pixel_size,
             rng=None, *, device='cuda') -> Dict:
    """One legacy sample: the 14 float16 maps of _KEYS and the warped
    pixel-space poses_past / poses_future. Point rows (N, >=8) numpy
    [x, y, z, intensity, r, g, b, sem]; the maps are rastered on
    ``device`` (the card unless the caller passes 'cpu'). The warp is
    always applied, its anchor drawn from ``rng`` (a numpy Generator)."""
    P = pixel_size
    aug_view = zoom_scalar * view_size
    rng = np.random.default_rng() if rng is None else rng
    j_mid = int(P / 2)
    i_warp, j_warp = warp_ops.get_random_warp_params(0.15, 0.30, P, P, rng)
    a_1, a_2 = warp_ops.cal_warp_params(i_warp, j_mid, P - 1)
    b_1, b_2 = warp_ops.cal_warp_params(j_warp, j_mid, P - 1)

    dev = torch.device(device)

    def rows(pc):
        return torch.as_tensor(np.asarray(pc, np.float32), device=dev)

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    maps = _gen_view_maps(
        rows(pc_past), rows(pc_future), scalar(rot_ang), scalar(trans_dx),
        scalar(trans_dy), scalar(aug_view), P, scalar(a_1), scalar(a_2),
        scalar(b_1), scalar(b_2)).cpu().numpy()
    bev = {k: maps[i] for i, k in enumerate(_KEYS)}
    bev['poses_past'], bev['poses_future'] = (
        _poses_to_grid(poses, rot_ang, trans_dx, trans_dy, aug_view, P, a_1,
                       a_2, j_mid, j_warp)
        for poses in (poses_past, poses_future))
    return bev


def gen_aug_view(inputs: Dict, rng=None, *, device='cuda') -> Dict:
    """gen_view under a random rotation, translation within
    inputs['max_translation_radius'] and zoom clipped to
    inputs['zoom_threshold'], drawn from ``rng``."""
    rng = np.random.default_rng() if rng is None else rng
    rot_ang = 2 * np.pi * rng.random()
    trans_r = inputs['max_translation_radius'] * rng.random()
    trans_ang = 2 * np.pi * rng.random()
    zoom = float(np.clip(rng.normal(0, 0.1), -inputs['zoom_threshold'],
                         inputs['zoom_threshold'])) + 1.0
    return gen_view(inputs['pc_present'], inputs['pc_future'],
                    inputs['poses_present'], inputs['poses_future'], rot_ang,
                    trans_r * np.cos(trans_ang), trans_r * np.sin(trans_ang),
                    zoom, inputs['view_size'], inputs['pixel_size'], rng=rng,
                    device=device)


def viz_bev(bev: Dict, file_path: str):
    """The legacy 2x5 panel as a PNG (matplotlib, imported here)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    H = np.asarray(bev['gridmap_past_road']).shape[0]
    plt.figure(figsize=(32, 18))
    panels = [('gridmap_past_road', dict(vmin=0, vmax=1), 1),
              ('gridmap_past_sidewalk', dict(vmin=0, vmax=1), 2),
              ('intensitymap_past_mean', dict(vmin=0, vmax=1), 3),
              ('gridmap_dynamic', dict(vmin=0, vmax=1), 4),
              ('elevmap_past_mean', dict(vmin=-2, vmax=2), 5),
              ('gridmap_future_road', dict(vmin=0, vmax=1), 6),
              ('intensitymap_future_mean', dict(vmin=0, vmax=1), 8)]
    for key, kw, slot in panels:
        plt.subplot(2, 5, slot)
        plt.imshow(np.asarray(bev[key], np.float32), **kw)
        if slot == 1 and bev['poses_past'].shape[0]:
            plt.plot(bev['poses_past'][:, 0], H - bev['poses_past'][:, 1],
                     'k-')
        if slot == 6 and bev['poses_future'].shape[0]:
            plt.plot(bev['poses_future'][:, 0],
                     H - bev['poses_future'][:, 1], 'r-')
    for slot, pre in ((9, 'past'), (10, 'future')):
        plt.subplot(2, 5, slot)
        rgb = np.stack([np.asarray(bev[f'{c}_map_{pre}'], np.float32)
                        for c in ('red', 'green', 'blue')], axis=-1)
        plt.imshow((rgb * 255).astype(int))
    plt.tight_layout()
    plt.savefig(file_path)
    plt.clf()
    plt.close()
