"""Semantic point cloud accumulator: host-side state machine around the
device point buffer.

Counterpart of accum/base.py. Points are stored once in a fixed world
frame (frame 0). BEVs are in the newest ego frame (bev_ref_frame =
'latest', the ICP accumulators: the world -> newest-ego transform is folded
into the raster) or in the fixed world frame ('world', the oracle-pose
accumulator). Memory-horizon eviction advances a window start; the device
read path masks by frame id and never moves data.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.accum import buffer
from pc_accumulation_lib_tpu_torch.bev import core as bev_core
from pc_accumulation_lib_tpu_torch.bev.rgb_bev import RGBBEVGenerator
from pc_accumulation_lib_tpu_torch.bev.sem_bev import SemBEVGenerator
from pc_accumulation_lib_tpu_torch.utils import profiling
from pc_accumulation_lib_tpu_torch.utils.io import (read_compressed_pickle,
                                                    write_compressed_pickle)


class SemanticPointCloudAccumulator:
    """Base accumulator on ``device`` (the card unless the caller passes
    'cpu'). Subclasses implement the per-platform integrate path."""

    # 'latest': BEVs in the newest ego frame; 'world': in the fixed first
    # ego frame.
    bev_ref_frame = 'latest'

    def __init__(self, horizon_dist: float, icp_threshold: float,
                 semseg_model=None, semseg_filters=cfg.DEFAULT_SEMSEG_FILTERS,
                 sem_idxs: Optional[dict] = None, use_gt_sem: bool = False,
                 bev_params: Optional[dict] = None,
                 accum_cfg: Optional[cfg.AccumConfig] = None,
                 seed: Optional[int] = None, *, device='cuda'):
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
        bev_type = bev_params.get('type', 'sem')
        if bev_type == 'sem':
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
                mesh=bev_params.get('mesh'),  # point-sharded over its ranks
                mesh_impl=bev_params.get('mesh_impl', 'auto'),
                device=self.device,
                sparse_cap=bev_params.get('sparse_cap'),
                fetch_group=bev_params.get('fetch_group', 4))
        elif bev_type == 'rgb':
            self.sem_bev_generator = RGBBEVGenerator(
                bev_params.get('view_size', 80),
                bev_params.get('pixel_size', 256),
                bev_params.get('max_trans_radius', 0.),
                bev_params.get('zoom_thresh', 0.),
                bev_params.get('do_warp', False),
                bev_params.get('int_scaler', 1.),
                bev_params.get('int_sep_scaler', 1.),
                bev_params.get('int_mid_threshold', 0.5),
                seed=seed, device=self.device)
        else:
            raise ValueError(f"bev_params['type'] must be 'sem' or 'rgb', "
                             f'got {bev_type!r}')

        a = self.accum_cfg
        self.state = buffer.init_state(a.max_frames, a.painted_cap,
                                       a.max_instances, self.device)
        # Host bookkeeping (in-horizon window only, trimmed on eviction).
        self.frame_count = 0          # next global frame id
        self.last_frame = None        # span frame id of the newest frame
        self.window_start = 0         # global id of first in-horizon frame
        self.poses: List[list] = []   # world-frame ego positions [x,y,z]
        self.T_world_velo: List[np.ndarray] = []  # per-frame velo->world
        self.seg_dists: List[float] = []
        self.rgbs: List = []
        self.semsegs: List = []

    # ------------------------------------------------------------------
    # Per-platform hooks
    # ------------------------------------------------------------------
    def integrate(self, observations: list):
        raise NotImplementedError()

    def obs2sem_vec_space(self, *args, **kwargs):
        raise NotImplementedError()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == 'cuda':
            # Pinned staging copy, so the upload is asynchronous.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

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

    def remove_observations(self):
        """Append the newest segment and evict the frames beyond the
        travelled-path memory horizon (host bookkeeping; the device masks
        by window start). Returns (num_removed, path_length)."""
        idx = 0
        self.seg_dists.append(self.dist(np.array(self.poses[-1]),
                                        np.array(self.poses[-2])))
        path_length = float(np.sum(self.seg_dists))
        if path_length > self.horizon_dist:
            overshoot = path_length - self.horizon_dist
            idx = int((self.get_incremental_path_dists() - overshoot > 0.)
                      .argmax())
            self._drop_oldest(idx)
        return idx, path_length

    def _drop_oldest(self, idx: int) -> None:
        """Drop the ``idx`` oldest frames from the host window."""
        self.poses = self.poses[idx:]
        self.seg_dists = self.seg_dists[idx:]
        self.T_world_velo = self.T_world_velo[idx:]
        self.rgbs = self.rgbs[idx:]
        self.semsegs = self.semsegs[idx:]
        self.window_start += idx

    @staticmethod
    def comp_incr_path_dist(seg_dists) -> np.ndarray:
        """Cumulative path distances."""
        return np.cumsum(np.asarray(seg_dists, np.float64))

    def get_segment_dists(self) -> list:
        return self.seg_dists

    def get_incremental_path_dists(self) -> np.ndarray:
        return self.comp_incr_path_dist(self.seg_dists)

    def get_pose(self, idx: Optional[int] = None) -> np.ndarray:
        """World-frame ego positions (all, or the one at ``idx``)."""
        if idx is None:
            return np.array(self.poses)
        return np.array(self.poses[idx])

    def get_rgb(self, idx: Optional[int] = None) -> list:
        return self.rgbs if idx is None else [self.rgbs[idx]]

    def get_semseg(self, idx: Optional[int] = None) -> list:
        return self.semsegs if idx is None else [self.semsegs[idx]]

    @staticmethod
    def dist(pose_0: np.ndarray, pose_1: np.ndarray) -> float:
        """Euclidean distance between poses."""
        return float(np.sqrt(np.sum((pose_1 - pose_0)**2)))

    def _ref_transform(self) -> np.ndarray:
        """World -> BEV-reference frame transform."""
        if self.bev_ref_frame == 'latest':
            return np.linalg.inv(self.T_world_velo[-1])
        return np.eye(4)

    def _poses_ref(self, T_ref_world: np.ndarray) -> np.ndarray:
        poses = np.array(self.poses, np.float64).reshape(-1, 3)
        return poses @ T_ref_world[:3, :3].T + T_ref_world[:3, 3]

    def _other_trajs(self, present_idx, gen_future):
        """Non-ego trajectories (present, future, full); platforms with
        object tracking override."""
        return [], [], []

    def _gt_lanes(self):
        return None

    def generate_bev(self, present_idx: Optional[int] = None,
                     bev_num: int = 1, gen_future: bool = False,
                     async_fetch: bool = False):
        """``bev_num`` BEV dicts around pose ``present_idx`` (default: the
        newest), rastered from the whole flat point buffer with the
        classic raster; frames outside the window are masked by frame id.
        With ``async_fetch`` returns a zero-arg callable yielding the list,
        after all device work and copies are queued. Spans 'generate_bev'
        (children 'trajs', 'raster', 'fetch') and, where the list is
        made, 'harvest', all of the newest frame."""
        frame = self.last_frame
        with profiling.span('generate_bev', frame):
            handle = self._dispatch_bev(present_idx, bev_num, gen_future)

        def finalize():
            with profiling.span('harvest', frame):
                bevs = handle()
                self._harvested()
            return bevs

        return finalize if async_fetch else finalize()

    def _harvested(self) -> None:
        """Host checks after a harvest, before its samples are returned."""

    def _dispatch_bev(self, present_idx, bev_num, gen_future):
        n_frames = len(self.poses)
        with profiling.span('trajs'):
            T_ref_world = self._ref_transform()
            poses_ref = self._poses_ref(T_ref_world)
            pi = n_frames if present_idx is None else present_idx
            ref_idx = (n_frames - 1) if present_idx is None else present_idx
            bev_coords = poses_ref[ref_idx]

            trajs: Dict = {'ego_traj_present': poses_ref[:pi] - bev_coords}
            other_p, other_f, other_full = self._other_trajs(pi, gen_future)
            trajs['other_trajs_present'] = other_p
            if gen_future:
                trajs['ego_traj_future'] = poses_ref[pi:] - bev_coords
                trajs['ego_traj_full'] = poses_ref - bev_coords
                trajs['other_trajs_future'] = other_f
                trajs['other_trajs_full'] = other_full
            lanes = self._gt_lanes()
            if lanes is not None:
                trajs['gt_lanes'] = [
                    np.asarray(ln, np.float64) @ T_ref_world[:3, :3].T
                    + T_ref_world[:3, 3] - bev_coords for ln in lanes]

        params = bev_core.identity_params(
            T_ref_world=T_ref_world.astype(np.float32),
            bev_coords=bev_coords.astype(np.float32),
            window=(self.window_start, self.frame_count - 1),
            present_frame=self.window_start + pi)
        f, n, d = self.state.points.shape
        return self.sem_bev_generator.generate_samples(
            self.state.points.view(f * n, d), self.state.valid.view(f * n),
            self.state.frame_ids.repeat_interleave(n), self.state.inst_dyn,
            params, trajs, bev_num, gen_future, async_fetch=True)

    write_compressed_pickle = staticmethod(write_compressed_pickle)
    read_compressed_pickle = staticmethod(read_compressed_pickle)

    def viz_bev(self, bev, file_path, rgbs: list = (), semsegs: list = ()):
        self.sem_bev_generator.viz_bev(bev, file_path, list(rgbs),
                                       list(semsegs))

    def get_vector_space(self) -> np.ndarray:
        """The in-window world-frame cloud as a numpy (N,10) array."""
        pts = self.state.points.cpu().numpy().reshape(-1, cfg.PT_DIM)
        valid = self.state.valid.cpu().numpy().reshape(-1)
        fids = np.repeat(self.state.frame_ids.cpu().numpy(),
                         self.state.points.shape[1])
        return pts[valid & (fids >= self.window_start)]

    def viz_sem_vec_space(self, file_path: str = 'sem_vec_space.ply',
                          color: str = 'rgb') -> int:
        """Write the in-window cloud as PLY, coloured by its RGB or, with
        ``color='dyn'``, yellow where the point or its instance is dynamic
        and blue elsewhere; the ego poses go to ``file_path``.poses.txt.
        Returns the point count."""
        from pc_accumulation_lib_tpu_torch.utils.ply import write_ply
        pts = self.get_vector_space()
        if color == 'dyn':
            inst_dyn = self.state.inst_dyn.cpu().numpy()
            inst = np.clip(pts[:, cfg.PT_INST].astype(int), 0,
                           inst_dyn.shape[0] - 1)
            dyn = np.maximum(pts[:, cfg.PT_DYN], inst_dyn[inst])
            rgb = np.where(dyn[:, None] > 0.5, np.array([[253, 231, 36]]),
                           np.array([[68, 2, 85]]))
        else:
            rgb = pts[:, cfg.PT_R:cfg.PT_B + 1]
        write_ply(file_path, pts[:, :3], rgb)
        np.savetxt(file_path + '.poses.txt', np.array(self.poses))
        return pts.shape[0]
