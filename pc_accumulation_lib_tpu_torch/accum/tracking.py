"""Fake object detection and tracking (host numpy).

The port's copy of accum/tracking.py. Per-instance pose histories keyed by
annotation token; an instance is flagged dynamic once the (x, y)
displacement between its first and latest observation exceeds a threshold;
past/future trajectories are split into runs of consecutive timestamps.

Each token gets a global instance id (0 = no instance); the device keeps a
per-id dynamic flag (accum/buffer.set_instance_dyn) that the raster folds
in, so flagging an instance relabels all its stored points at once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Tracked detection classes: car, truck, construction vehicle, bus,
# motorcycle (trailer, bicycle and pedestrian are not tracked).
TRACK_INST_CLASSES = (0, 1, 2, 3, 5)


class InstanceTracker:

    def __init__(self, dyn_trans_thresh: float = 1.0,
                 track_inst_clss=TRACK_INST_CLASSES):
        self.dyn_obj_trans_thresh = dyn_trans_thresh
        self.track_inst_clss = tuple(track_inst_clss)
        # token -> [(pose_world (3,), ts), ...]
        self.instances: Dict[str, list] = {}
        self.dyn_instances: List[str] = []      # tokens flagged dynamic
        self.token2global: Dict[str, int] = {}  # token -> global inst id
        self._next_global = 1                   # 0 = no instance

    def global_id(self, token: str) -> int:
        if token not in self.token2global:
            self.token2global[token] = self._next_global
            self._next_global += 1
        return self.token2global[token]

    def update(self, ts: int, inst_tokens, inst_clss, inst_centers_world):
        """Track one frame's detections.

        Args:
          inst_centers_world: (3,) world-frame object centre per token.
        Returns:
          frame_to_global: dict frame_inst_idx -> global id (for remapping
            the per-point instance column);
          newly_dynamic: global ids that became dynamic this frame (for
            buffer.set_instance_dyn).
        """
        frame_to_global = {}
        newly_dynamic = []
        for idx, token in enumerate(inst_tokens):
            if inst_clss[idx] not in self.track_inst_clss:
                continue
            pose = np.asarray(inst_centers_world[idx], np.float64)
            self.instances.setdefault(token, []).append((pose, ts))
            gid = self.global_id(token)
            frame_to_global[idx] = gid
            if token in self.dyn_instances:
                continue
            history = self.instances[token]
            if len(history) < 2:
                continue
            delta = np.linalg.norm(history[-1][0][:2] - history[0][0][:2])
            if delta > self.dyn_obj_trans_thresh:
                self.dyn_instances.append(token)
                newly_dynamic.append(gid)
        return frame_to_global, newly_dynamic

    # ------------------------------------------------------------------
    # Trajectory extraction
    # ------------------------------------------------------------------
    @staticmethod
    def find_nearest_ge_idx(array, target_val):
        """First index whose value is >= target."""
        for idx, val in enumerate(array):
            if val >= target_val:
                return idx
        raise ValueError(f'Value {target_val} not in array {array}')

    @staticmethod
    def find_nearest_le_idx(array, target_val):
        """Last index whose value is <= target (values ascending)."""
        if array[0] > target_val:
            raise ValueError(f'Value {target_val} not in array {array}')
        for idx in range(len(array) - 1):
            if array[idx + 1] > target_val:
                return idx
        return len(array) - 1

    @staticmethod
    def parse_seq_into_coherent_seqs(ts: list) -> List[List[int]]:
        """Split timestamps into runs of consecutive steps, as local
        indices. A gap before the first run leaves an empty leading run."""
        seq_tss = [[]]
        t_prev = ts[0] - 1
        for seq_idx, t in enumerate(ts):
            if t - t_prev != 1:
                seq_tss.append([])
            seq_tss[-1].append(seq_idx)
            t_prev = t
        return seq_tss

    def parse_coherent_pose_seqs(self, poses, tss):
        """The poses of each run of consecutive timestamps, as lists."""
        return [[np.asarray(poses[t]).tolist() for t in seq]
                for seq in self.parse_seq_into_coherent_seqs(tss)]

    def get_dyn_obj_trajs(self, ts_start: int = 0,
                          ts_end: Optional[int] = None,
                          ego_poses: Optional[list] = None) -> list:
        """Dynamic-object trajectories within [ts_start, ts_end] as lists
        of (x, y, z) pose lists; runs shorter than 2 poses are dropped;
        ``ego_poses``, when given, is appended last."""
        seq_poses_set = []
        for token, pose_obss in self.instances.items():
            if token not in self.dyn_instances:
                continue
            poses, tss = zip(*pose_obss)
            try:
                idx_start = self.find_nearest_ge_idx(tss, ts_start)
                idx_end = None
                if ts_end is not None:
                    idx_end = self.find_nearest_le_idx(tss, ts_end) + 1
            except ValueError:
                continue
            poses = poses[idx_start:idx_end]
            tss = tss[idx_start:idx_end]
            for seq_pose in self.parse_coherent_pose_seqs(poses, tss):
                if len(seq_pose) >= 2:
                    seq_poses_set.append(seq_pose)
        if ego_poses is not None:
            seq_poses_set.append(ego_poses)
        return seq_poses_set

    def get_split_dyn_obj_trajs(self, split_idx: int) -> Tuple[list, list,
                                                               list]:
        """(past up to split_idx, future from split_idx, full)."""
        past = self.get_dyn_obj_trajs(ts_end=split_idx)
        future = self.get_dyn_obj_trajs(ts_start=split_idx)
        full = self.get_dyn_obj_trajs()
        return past, future, full
