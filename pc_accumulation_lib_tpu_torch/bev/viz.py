"""BEV visualization PNG export.

The port's copy of the JAX package's bev/viz.py (counterpart of
SemBEVGenerator.viz_bev, sem_bev.py:264-533): channel panels x
present/future/full splits, red ego/other trajectories with arrow heads,
GT lanes over road_full, camera images with a road-class overlay. Every
channel family gets its own row (the reference's panel overlaps dynamic
and intensity when there are at most 3 camera images), with per-subplot
titles and colorbars on the scalar maps. matplotlib is imported only when
a PNG is drawn.
"""
from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _plot_trajs(plt, trajs, H, color='r'):
    for traj in trajs:
        traj = np.asarray(traj)
        if traj.shape[0] == 0:
            continue
        plt.plot(traj[:, 0], H - traj[:, 1], f'{color}-')
        if traj.shape[0] < 2:
            continue
        x = traj[-2, 0]
        y = H - traj[-2, 1]
        dx = traj[-1, 0] - x
        dy = H - traj[-1, 1] - y
        plt.arrow(x, y, dx, dy, head_width=4, color=color)


def viz_bev(bev, file_path, pixel_size, height_filter=None, rgbs=(),
            semsegs=()):
    plt = _pyplot()
    H = pixel_size
    num_imgs = len(rgbs)

    if 'road_future' not in bev:
        plt.figure(figsize=(6, 6))
        plt.imshow(np.asarray(bev['road_present'], np.float32), vmin=0,
                   vmax=1)
        plt.title('road_present')
        _plot_trajs(plt, bev['trajs_present'], H)
        plt.tight_layout()
        plt.savefig(file_path)
        plt.clf()
        plt.close()
        return

    splits = ('present', 'future', 'full')
    elev_hi = height_filter if height_filter is not None else 3.0
    # (channel family, imshow kwargs, show colorbar)
    rows = [
        ('road', dict(vmin=0, vmax=1), True),
        ('dynamic', dict(vmin=0, vmax=1), True),
        ('intensity', dict(vmin=0, vmax=1), True),
        ('elevation', dict(vmin=-0.5, vmax=elev_hi), True),
        ('rgb', {}, False),
    ]
    num_cols = max(3, num_imgs)
    num_rows = len(rows) + (1 if num_imgs > 0 else 0)
    plt.figure(figsize=(6 * num_cols, 6 * num_rows))

    ax_rgb_last = None
    for r, (family, kw, cbar) in enumerate(rows):
        for c, s in enumerate(splits):
            plt.subplot(num_rows, num_cols, r * num_cols + c + 1)
            if family == 'rgb':
                img = np.transpose(
                    np.asarray(bev[f'rgb_{s}'], np.float32), (1, 2, 0))
                plt.imshow((img * 255).astype(int))
                ax_rgb_last = plt.gca()
            else:
                plt.imshow(np.asarray(bev[f'{family}_{s}'], np.float32),
                           **kw)
                if cbar:
                    plt.colorbar(fraction=0.046)
            plt.title(f'{family}_{s}')
            _plot_trajs(plt, bev[f'trajs_{s}'], H)
        if family == 'rgb' and 'gt_lanes' in bev and num_cols > 3:
            plt.subplot(num_rows, num_cols, r * num_cols + 4)
            plt.imshow(np.asarray(bev['road_full'], np.float32), vmin=0,
                       vmax=1)
            plt.title('gt_lanes over road_full')
            for lane in bev['gt_lanes']:
                _plot_trajs(plt, [lane], H, color='k')

    if 'gt_lanes' in bev and num_cols == 3 and ax_rgb_last is not None:
        # No spare column: overlay the lanes on the last rgb panel by
        # re-activating its AXES object. (Calling plt.subplot with the
        # same spec creates a NEW blank axes on matplotlib >= 3.6 —
        # an opaque patch over the image with an un-inverted y axis.)
        plt.sca(ax_rgb_last)
        for lane in bev['gt_lanes']:
            _plot_trajs(plt, [lane], H, color='k')

    for idx in range(num_imgs):
        plt.subplot(num_rows, num_cols, len(rows) * num_cols + idx + 1)
        plt.imshow(rgbs[idx])
        plt.title(f'camera {idx}')
        if idx < len(semsegs) and semsegs[idx] is not None:
            plt.imshow(np.asarray(semsegs[idx]) == 0, alpha=0.5, vmin=0,
                       vmax=1)

    plt.tight_layout()
    plt.savefig(file_path)
    plt.clf()
    plt.close()
