"""NuScenes observation dataloader (host numpy).

The port's copy of dataloaders/nuscenes.py: per keyframe, the multi-sweep
instance-labelled points in the ego frame, the 6 camera images with each
point's (u, v) and camera (one batched projection over the rig), the GT
box instances and the global ego position. The devkit object is passed in
(the nuscenes-devkit's NuScenes, or any object with its query surface);
camera images are opened with PIL when a keyframe is read.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from pc_accumulation_lib_tpu_torch.dataloaders import nuscenes_utils as nu
from pc_accumulation_lib_tpu_torch.dataloaders.base import (
    ObservationDataloader)

CAM_CHANNELS = ('CAM_FRONT', 'CAM_FRONT_LEFT', 'CAM_FRONT_RIGHT',
                'CAM_BACK', 'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')

# Columns of the (N,8) multi-sweep point rows of inst_centric_get_sweeps:
# [x, y, z, intensity, time_lag, sweep, inst, cls].
SWEEP_COLS = dict(int_idx=3, time_idx=4, sweep_idx=5, inst_idx=6, cls_idx=7)

# Extraction range wide enough to keep every point; the BEV crop bounds
# the view downstream.
_UNBOUNDED_M = 1000.0


def keyframe_tokens(nusc, scene_ids: Iterable[int]) -> List[str]:
    """The chosen scenes' keyframe sample tokens, in order."""
    tokens = []
    for scene_idx in scene_ids:
        tok = nusc.scene[scene_idx]['first_sample_token']
        while tok:
            tokens.append(tok)
            tok = nusc.get('sample', tok)['next']
    return tokens


class NuScenesDataloader(ObservationDataloader):
    """Index-based keyframe loader over one or more NuScenes scenes."""

    def __init__(self, nusc, scene_ids: Optional[List[int]] = None,
                 batch_size: int = 1, num_sweeps: int = 5):
        """``num_sweeps``: how many lidar sweeps, the keyframe's included,
        merge into each keyframe cloud."""
        super().__init__(None, batch_size)
        self.nusc = nusc
        self.num_sweeps = num_sweeps
        self.cam_channels = list(CAM_CHANNELS)
        self.sample_tokens = keyframe_tokens(
            nusc, range(len(nusc.scene)) if scene_ids is None else scene_ids)
        v = _UNBOUNDED_M
        self.pc_range = [-v, -v, -v, v, v, v]

    def __len__(self) -> int:
        return len(self.sample_tokens)

    def _fetch_sweeps(self, sample_token: str) -> dict:
        """Multi-sweep instance-labelled cloud in the lidar frame."""
        return nu.inst_centric_get_sweeps(
            self.nusc, sample_token,
            n_sweeps=self.num_sweeps,
            center_radius=2.0,
            in_box_tolerance=5e-2,
            return_instances_last_box=True,
            point_cloud_range=self.pc_range,
            detection_classes=nu.DETECTION_CLASSES,
            map_point_feat2idx={k: SWEEP_COLS[k] for k in
                                ('sweep_idx', 'inst_idx', 'cls_idx')})

    def _rig(self, sample: dict):
        """The six camera sensors of one sample."""
        return [nu.NuScenesCamera(self.nusc,
                                  self.nusc.get('sample_data',
                                                sample['data'][c]))
                for c in self.cam_channels]

    def read_obs(self, idx: int) -> dict:
        """One keyframe observation dict:

          images:          the 6 camera images (PIL)
          pc:              (N,7) [x, y, z (ego frame), intensity, u, v,
                           instance idx (-1 = background)]
          pc_cam_idx:      (N,) camera a point projects into (-1 = none)
          ego_at_lidar_ts: (4,4) global <- ego at the lidar timestamp
          inst_tokens / inst_cls / inst_center: GT box instances, one
                           entry per box occurrence
          ego_global_x/y:  ego map position
          meta:            sample/scene tokens and camera channel names
        """
        token = self.sample_tokens[idx]
        sample = self.nusc.get('sample', token)
        sweeps = self._fetch_sweeps(token)
        pts = np.asarray(sweeps['points'], np.float64)   # lidar frame, (N,8)

        lidar = nu.NuScenesLidar(
            self.nusc,
            self.nusc.get('sample_data', sample['data']['LIDAR_TOP']))
        xyz_ego = nu.homo_transform(lidar.ego_from_self, pts[:, :3])
        xyz_glob = nu.homo_transform(lidar.glob_from_ego, xyz_ego)

        cameras = self._rig(sample)
        uv, cam_idx = nu.project_points_to_rig(
            xyz_glob,
            np.linalg.inv(np.stack([c.glob_from_self for c in cameras])),
            np.stack([c.cam_K for c in cameras]),
            np.stack([c.img_wh for c in cameras]))

        feature_rows = np.column_stack([
            xyz_ego, pts[:, SWEEP_COLS['int_idx']], uv,
            pts[:, SWEEP_COLS['inst_idx']]])
        # inst_tokens / inst_center are per box occurrence; inst_cls is
        # made per occurrence too (instances_name is per unique instance,
        # in first-appearance order), so the three lists are parallel.
        uniq = {}
        for t in sweeps['instances_token']:
            uniq.setdefault(t, len(uniq))
        occ_cls = [int(sweeps['instances_name'][uniq[t]])
                   for t in sweeps['instances_token']]
        ego_xy = lidar.glob_from_ego[:2, 3]
        return {
            'images': [c.img for c in cameras],
            'pc': feature_rows,
            'pc_cam_idx': cam_idx,
            'ego_at_lidar_ts': lidar.glob_from_ego,
            'inst_tokens': sweeps['instances_token'],
            'inst_cls': occ_cls,
            'inst_center': sweeps['instances_center'],
            'ego_global_x': float(ego_xy[0]),
            'ego_global_y': float(ego_xy[1]),
            'meta': {
                'sample_token': token,
                'scene_token': sample['scene_token'],
                'cam_channels': self.cam_channels,
            },
        }
