"""Semantic point cloud accumulator: host-side state machine around the
device point buffer.

Counterpart of accum/base.py. Points are stored once in a fixed world
frame (frame 0); the world -> newest-ego transform is folded into the
raster at BEV time. Memory-horizon eviction advances a window start; the
device read path masks by frame id and never moves data.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.accum import buffer
from pc_accumulation_lib_tpu_torch.bev.sem_bev import SemBEVGenerator


class SemanticPointCloudAccumulator:
    """Base accumulator on an explicit ``device``. Subclasses implement
    the per-platform integrate path; BEVs are in the newest ego frame."""

    def __init__(self, horizon_dist: float, icp_threshold: float,
                 semseg_model=None, semseg_filters=cfg.DEFAULT_SEMSEG_FILTERS,
                 sem_idxs: Optional[dict] = None, use_gt_sem: bool = False,
                 bev_params: Optional[dict] = None,
                 accum_cfg: Optional[cfg.AccumConfig] = None,
                 seed: Optional[int] = None, *, device):
        self.device = torch.device(device)
        self.horizon_dist = horizon_dist
        self.icp_threshold = icp_threshold
        self.semseg_model = semseg_model
        self.semseg_filters = tuple(int(f) for f in semseg_filters)
        self.sem_idxs = dict(sem_idxs or cfg.DEFAULT_SEM_IDXS)
        self.use_gt_sem = use_gt_sem
        self.accum_cfg = accum_cfg or cfg.AccumConfig(
            horizon_dist=horizon_dist, icp_threshold=icp_threshold,
            use_gt_sem=use_gt_sem, semseg_filters=self.semseg_filters)

        bev_params = bev_params or {}
        if bev_params.get('type', 'sem') != 'sem':
            raise NotImplementedError('the port has the semantic BEV only')
        self.sem_bev_generator = SemBEVGenerator(
            self.sem_idxs,
            bev_params.get('view_size', 80),
            bev_params.get('pixel_size', 256),
            bev_params.get('max_trans_radius', 0.),
            bev_params.get('zoom_thresh', 0.),
            bev_params.get('do_warp', False),
            bev_params.get('int_scaler', 1.),
            bev_params.get('int_sep_scaler', 1.),
            bev_params.get('int_mid_threshold', 0.5),
            bev_params.get('height_filter'),
            seed=seed,
            fetch_dtype=bev_params.get('fetch_dtype', 'float16'),
            device=self.device)

        a = self.accum_cfg
        self.state = buffer.init_state(a.max_frames, a.painted_cap,
                                       a.max_instances, self.device)
        # Host bookkeeping (in-horizon window only, trimmed on eviction).
        self.frame_count = 0          # next global frame id
        self.window_start = 0         # global id of first in-horizon frame
        self.poses: List[list] = []   # world-frame ego positions [x,y,z]
        self.T_world_velo: List[np.ndarray] = []  # per-frame velo->world
        self.seg_dists: List[float] = []
        self.rgbs: List = []
        self.semsegs: List = []

    def _append_frame_meta(self, T_world_velo, rgb, semseg):
        """Host bookkeeping for a frame already inserted on the device
        (its id was reserved at dispatch)."""
        if len(self.poses) >= self.accum_cfg.max_frames:
            raise RuntimeError(
                f'Point buffer frame overflow: window of {len(self.poses)} '
                f'frames exceeds max_frames={self.accum_cfg.max_frames}; '
                'raise AccumConfig.max_frames (points must not be silently '
                'dropped).')
        self.T_world_velo.append(np.asarray(T_world_velo, np.float64))
        self.poses.append(list(np.asarray(T_world_velo, np.float64)[:3, 3]))
        self.rgbs.append(rgb)
        self.semsegs.append(semseg)

    @staticmethod
    def dist(pose_0: np.ndarray, pose_1: np.ndarray) -> float:
        """Euclidean distance between poses."""
        return float(np.sqrt(np.sum((pose_1 - pose_0)**2)))

    def _ref_transform(self) -> np.ndarray:
        """World -> BEV-reference (newest ego) frame transform."""
        return np.linalg.inv(self.T_world_velo[-1])

    def _poses_ref(self, T_ref_world: np.ndarray) -> np.ndarray:
        poses = np.array(self.poses, np.float64).reshape(-1, 3)
        return poses @ T_ref_world[:3, :3].T + T_ref_world[:3, 3]
