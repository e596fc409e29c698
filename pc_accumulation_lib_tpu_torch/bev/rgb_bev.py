"""RGB-only BEV generator.

Counterpart of bev/rgb_bev.py: the semantic generator's raster (so the
stats kernel runs on this path too), keeping only the per-cell median RGB
maps of the present and future splits and the pixel-space ego poses.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pc_accumulation_lib_tpu_torch.bev.sem_bev import SemBEVGenerator

# The raster needs a sem_idxs map; the RGB output ignores the semantic
# channels.
_SEM_IDXS = {'road': 0, 'car': 13, 'truck': 14, 'bus': 15, 'motorcycle': 17}


class RGBBEVGenerator(SemBEVGenerator):
    """Samples with the keys rgb_present, poses_present and, with
    gen_future, rgb_future and poses_future. Constructor arguments as the
    JAX package's, plus ``device``."""

    def __init__(self, view_size: float, pixel_size: int,
                 max_trans_radius: float = 0., zoom_thresh: float = 0.,
                 do_warp: bool = False, int_scaler: float = 1.,
                 int_sep_scaler: float = 1., int_mid_threshold: float = 0.5,
                 rgb_fill: int = 0, seed: Optional[int] = None, *,
                 device='cuda'):
        super().__init__(_SEM_IDXS, view_size, pixel_size, max_trans_radius,
                         zoom_thresh, do_warp, int_scaler, int_sep_scaler,
                         int_mid_threshold, None, rgb_fill, seed,
                         device=device)

    def _assemble(self, stack, trajs, rot_ang, dx, dy, aug_view, w,
                  gen_future) -> Dict:
        full = super()._assemble(stack, trajs, rot_ang, dx, dy, aug_view, w,
                                 gen_future)
        none = [np.zeros((0, 3))]
        bev = {'rgb_present': full['rgb_present'],
               'poses_present': (full.get('trajs_present') or none)[0]}
        if gen_future:
            bev['rgb_future'] = full['rgb_future']
            bev['poses_future'] = (full.get('trajs_future') or none)[0]
        return bev

    def viz_bev(self, bev, file_path, rgbs=None, semsegs=None):
        """The present and future RGB maps side by side, each with its
        poses, as a PNG (matplotlib, imported here)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        H = self.pixel_size
        plt.figure(figsize=(12, 6))
        for i, (mkey, pkey, style) in enumerate(
                (('rgb_present', 'poses_present', 'b-'),
                 ('rgb_future', 'poses_future', 'r-'))):
            if mkey not in bev:
                continue
            plt.subplot(1, 2, i + 1)
            img = np.transpose(np.asarray(bev[mkey], np.float32), (1, 2, 0))
            plt.imshow((img * 255).astype(int))
            poses = np.asarray(bev[pkey])
            if poses.shape[0]:
                plt.plot(poses[:, 0], H - poses[:, 1], style)
        plt.tight_layout()
        plt.savefig(file_path)
        plt.clf()
        plt.close()
