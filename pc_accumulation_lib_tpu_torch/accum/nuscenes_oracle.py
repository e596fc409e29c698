"""NuScenes oracle-pose accumulator: ground-truth ego poses, 6-camera
painting, fake detection and tracking, optional GT lane centerlines.

Counterpart of accum/nuscenes_oracle.py:
  * the fixed world frame is the first ego pose (bev_ref_frame='world');
  * no memory-horizon eviction;
  * tracking is accum/tracking.InstanceTracker on the host; an instance
    flagged dynamic raises its id in the device table inst_dyn
    (buffer.set_instance_dyn), which the raster folds into every stored
    point of the instance;
  * one frame's device work is one function (``decode_multicam``,
    ``paint_insert_multicam`` and the dyn update): the images of all
    cameras go through one batched semseg forward and one gather paint.

The camera wire is 'rgb8' (uint8), 'yuv420' or 'yuv420h' (ops/imgcodec.py:
encoded on the host, decoded in the frame step); the point wire is
'float32' or 'quantized' (accum/pointpack.py, 13 B/point, unpacked in the
frame step).
"""
from __future__ import annotations

import collections
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.accum import buffer, pointpack, tracking
from pc_accumulation_lib_tpu_torch.accum.base import (
    SemanticPointCloudAccumulator)
from pc_accumulation_lib_tpu_torch.ops import imgcodec
from pc_accumulation_lib_tpu_torch.utils import profiling

_MAX_DYN_UPDATES = 64  # padded per-frame dynamic-flag update batch


def check_wire(img_transfer: str, transfer_dtype: str) -> None:
    """The JAX package's wire names: 'rgb8', 'yuv420' or 'yuv420h' for
    the cameras, 'float32' or 'quantized' for the points."""
    if img_transfer not in ('rgb8',) + imgcodec.WIRES:
        raise ValueError(f'img_transfer={img_transfer!r}')
    if transfer_dtype not in ('float32', 'quantized'):
        raise ValueError(f'transfer_dtype={transfer_dtype!r}')


def encode_multicam_obs(obs: dict, n_pad: int, img_transfer: str = 'rgb8',
                        transfer_dtype: str = 'float32'):
    """Host arrays of one NuScenes observation on its wires: (pc (N,C)
    float32, the points (n_pad,C) float32 or, quantized, (n_pad*13,)
    uint8, valid (n_pad,) bool, cam_idx (n_pad,) int32 with -1 padding,
    the image parts: (imgs (cams,H,W,3) uint8,) for 'rgb8', else the yuv
    wire's tuple)."""
    pc = np.asarray(obs['pc'], np.float32)
    if pc.shape[0] > n_pad:
        raise RuntimeError(
            f'Frame has {pc.shape[0]} points > max_points_per_frame='
            f'{n_pad}.')
    if transfer_dtype == 'quantized':
        pc_wire = pointpack.pack_points7_np(pc, n_pad)
    else:
        pc_wire = np.zeros((n_pad, pc.shape[1]), np.float32)
        pc_wire[:pc.shape[0]] = pc
    cam_idx = -np.ones(n_pad, np.int32)
    cam_idx[:pc.shape[0]] = np.asarray(obs['pc_cam_idx'], np.int32)
    valid = np.arange(n_pad) < pc.shape[0]
    imgs = np.stack([np.asarray(im)[..., :3].astype(np.uint8)
                     for im in obs['images']])
    parts = (imgcodec.encode_wire(imgs, img_transfer)
             if img_transfer in imgcodec.WIRES else (imgs,))
    return pc, pc_wire, valid, cam_idx, tuple(parts)


def decode_multicam(pc_wire: torch.Tensor, img_parts: tuple, n_pad: int):
    """The device half of encode_multicam_obs: (points (n_pad,C)
    float32, images (cams,H,W,3) float32 in [0, 255])."""
    pc_pad = (pointpack.unpack_points7(pc_wire, n_pad)
              if pc_wire.dtype == torch.uint8 else pc_wire)
    imgs = (imgcodec.decode_wire(img_parts) if len(img_parts) > 1
            else img_parts[0].to(torch.float32))
    return pc_pad, imgs


@torch.no_grad()
def paint_insert_multicam(state, semseg_model, filters, cap: int, pc_pad,
                          valid, cam_idx, imgs, T_world_ego, inst_remap,
                          frame_id: int, dyn_updates=None):
    """One frame's paint on the device: one batched semseg forward over
    the cameras' float images, the multi-camera paint, compact_rows and
    the ring insert (in place), and with ``dyn_updates`` (padded newly
    dynamic instance ids, 0 a no-op) their flags raised in the dyn table.
    Spans 'semseg', 'paint' and 'insert'. Returns (painted count 0-d
    tensor, semsegs (cams,H,W) int32)."""
    with profiling.span('semseg', device=True):
        semsegs = semseg_model.predict(imgs)
    with profiling.span('paint', device=True):
        painted, valid_out = buffer.paint_frame_multicam(
            pc_pad, valid, cam_idx, imgs, semsegs, T_world_ego, inst_remap,
            filters)
    with profiling.span('insert', device=True):
        painted, valid_out, n_valid = buffer.compact_rows(painted,
                                                          valid_out, cap)
        buffer.insert_frame(state, painted, valid_out, frame_id)
        if dyn_updates is not None:
            buffer.set_instance_dyn(state, dyn_updates,
                                    (dyn_updates > 0).to(torch.float32))
    return n_valid, semsegs


def instance_tables(pc: np.ndarray, inst_tokens, frame_to_global: dict,
                    newly_dynamic: list):
    """(remap, dyn_updates) int32 host arrays for one frame.

    The point cloud's instance column holds the first-appearance index of
    a token among ``inst_tokens`` (a token repeats once per sweep that saw
    it), while the tracker keys its results by the occurrence index: remap
    maps first-appearance index + 1 to the global id (0 = untracked).
    dyn_updates holds the newly dynamic global ids, padded with the no-op
    id 0."""
    max_fi = int(pc[:, 6].max()) if pc.shape[0] else -1
    remap = np.zeros(max(max_fi + 2, 2), np.int32)
    uniq: dict = {}
    for t in inst_tokens:
        uniq.setdefault(t, len(uniq))
    for occ_idx, gid in frame_to_global.items():
        fi = uniq[inst_tokens[occ_idx]]
        if fi + 1 < remap.shape[0]:
            remap[fi + 1] = gid
    dyn_updates = np.zeros(_MAX_DYN_UPDATES, np.int32)
    ids = newly_dynamic[:_MAX_DYN_UPDATES]
    dyn_updates[:len(ids)] = ids
    return remap, dyn_updates


class OracleDeviceObs(NamedTuple):
    """An uploaded observation (``upload_obs``): the points, validity,
    camera indices and image parts on their wires, on the device; the
    host ``obs`` dict and points for the tracking and pose work done in
    integrate order; the frame id of its spans (profiling.new_frame)."""
    obs: dict
    pc: np.ndarray
    pc_pad: torch.Tensor
    valid: torch.Tensor
    cam_idx: torch.Tensor
    imgs: tuple
    frame: int


class NuScenesOracleSemanticPointCloudAccumulator(
        SemanticPointCloudAccumulator):

    bev_ref_frame = 'world'

    def __init__(self, semseg_model=None,
                 semseg_filters=cfg.DEFAULT_SEMSEG_FILTERS,
                 sem_idxs: Optional[dict] = None, use_gt_sem: bool = False,
                 bev_params: Optional[dict] = None, loc: Optional[str] = None,
                 get_gt_lanes: bool = False, dataroot: Optional[str] = None,
                 accum_cfg: Optional[cfg.AccumConfig] = None,
                 gt_lane_poses: Optional[list] = None,
                 seed: Optional[int] = None,
                 img_transfer: str = 'rgb8',
                 transfer_dtype: str = 'float32', *, device='cuda'):
        """Arguments as the JAX package's, plus ``device`` (the card unless
        the caller passes 'cpu'); ``semseg_model`` is a
        models.semseg.SemSegTorch on the same device. ``gt_lane_poses``
        may be given instead of loading the lanes with the devkit's map
        expansion. ``img_transfer`` and ``transfer_dtype`` name the camera
        and point wires (check_wire)."""
        check_wire(img_transfer, transfer_dtype)
        if use_gt_sem:
            raise NotImplementedError()
        super().__init__(np.inf, np.inf, semseg_model, semseg_filters,
                         sem_idxs, use_gt_sem, bev_params, accum_cfg, seed,
                         device=device)
        self.ts = 0
        self.T_global_world = None
        self.ego_pose_z = 1.0
        self.tracker = tracking.InstanceTracker()
        self.map = loc
        self.ego_global_xs: List[float] = []
        self.ego_global_ys: List[float] = []
        self.get_gt_lanes = get_gt_lanes
        self.gt_lane_poses = gt_lane_poses
        if self.get_gt_lanes and self.gt_lane_poses is None:
            from pc_accumulation_lib_tpu_torch.dataloaders.lanemap import (
                get_centerlines)
            self.gt_lane_poses = get_centerlines(dataroot, loc)
        self.img_transfer = img_transfer
        self.transfer_dtype = transfer_dtype
        self.upload_bytes_total = 0   # host -> device observation bytes
        self.upload_frames = 0
        # Painted counts of integrated frames not yet read on the host, and
        # the largest one read. The dispatching thread and a finalize on a
        # drain thread both take them (_painted_lock).
        self._painted_pending = collections.deque()
        self._painted_lock = threading.Lock()
        self.max_painted = 0

    # ------------------------------------------------------------------
    # Upload and integrate
    # ------------------------------------------------------------------
    def upload_obs(self, obs) -> OracleDeviceObs:
        """Start the host -> device upload of one observation dict; the
        result is accepted by ``integrate`` in its place. Tracking and pose
        state are not touched here. Span 'upload' (a new frame id);
        counters 'upload.bytes' and the pinned allocations."""
        if isinstance(obs, OracleDeviceObs):
            return obs
        frame = profiling.new_frame()
        with profiling.span('upload', frame), profiling.pinned_allocs():
            pc, pc_wire, valid, cam_idx, parts = encode_multicam_obs(
                obs, self.accum_cfg.max_points_per_frame, self.img_transfer,
                self.transfer_dtype)
            nbytes = (pc_wire.nbytes + cam_idx.nbytes + valid.size
                      + sum(p.nbytes for p in parts))
            self.upload_bytes_total += nbytes
            self.upload_frames += 1
            profiling.count('upload.bytes', nbytes)
            return OracleDeviceObs(obs, pc, self._to_device(pc_wire),
                                   self._to_device(valid),
                                   self._to_device(cam_idx),
                                   tuple(self._to_device(p) for p in parts),
                                   frame)

    def integrate(self, observations: list) -> int:
        """Integrate observation dicts or ``OracleDeviceObs``. No eviction:
        returns 0."""
        for obs in observations:
            self._integrate_one(obs)
        return 0

    @torch.no_grad()
    def _fused_step(self, dev: OracleDeviceObs, T_world_ego, remap,
                    dyn_updates, frame_id: int):
        """One frame's device work: wire decode, paint, insert, dyn-table
        update."""
        with profiling.span('decode', device=True):
            pc_pad, imgs = decode_multicam(
                dev.pc_pad, dev.imgs, self.accum_cfg.max_points_per_frame)
        return paint_insert_multicam(
            self.state, self.semseg_model, self.semseg_filters,
            self.accum_cfg.painted_cap, pc_pad, dev.valid, dev.cam_idx,
            imgs, T_world_ego, remap, frame_id, dyn_updates)

    def _integrate_one(self, obs):
        dev = self.upload_obs(obs)
        self.last_frame = dev.frame
        with profiling.span('integrate', dev.frame):
            self._integrate_device_obs(dev)

    def _integrate_device_obs(self, dev: OracleDeviceObs):
        self.check_painted()
        obs, pc = dev.obs, dev.pc
        T_ego_global = np.asarray(obs['ego_at_lidar_ts'], np.float64)
        if self.T_global_world is None:
            # World frame := the first ego frame.
            self.T_global_world = np.linalg.inv(T_ego_global)
            if self.get_gt_lanes and self.gt_lane_poses is not None:
                self.gt_lane_poses = [
                    np.asarray(ln) @ self.T_global_world[:3, :3].T
                    + self.T_global_world[:3, 3] for ln in self.gt_lane_poses]
        T_ego_world = self.T_global_world @ T_ego_global
        pose = T_ego_world[:3, -1].tolist()
        pose[2] += self.ego_pose_z

        # Fake detection and tracking on the host.
        with profiling.span('track'):
            centers_world = [self.T_global_world[:3, :3] @ np.asarray(c)
                             + self.T_global_world[:3, 3]
                             for c in obs['inst_center']]
            frame_to_global, newly_dynamic = self.tracker.update(
                self.ts, obs['inst_tokens'], obs['inst_cls'], centers_world)
            if self.tracker._next_global >= self.accum_cfg.max_instances:
                raise RuntimeError(
                    f'Instance table overflow (> '
                    f'{self.accum_cfg.max_instances}); raise '
                    'AccumConfig.max_instances.')
            remap, dyn_updates = instance_tables(
                pc, obs['inst_tokens'], frame_to_global, newly_dynamic)

        n_valid, semsegs = self._fused_step(
            dev, self._to_device(T_ego_world.astype(np.float32)),
            self._to_device(remap), self._to_device(dyn_updates),
            self.frame_count)
        self.frame_count += 1
        self._queue_painted(n_valid)
        self._append_frame_meta(T_ego_world, obs['images'], semsegs)
        self.ego_global_xs.append(obs['ego_global_x'])
        self.ego_global_ys.append(obs['ego_global_y'])
        # Oracle pose: the world-frame ego position with the z-lift.
        self.poses[-1] = pose
        if len(self.poses) > 1:
            self.seg_dists.append(self.dist(np.array(self.poses[-1]),
                                            np.array(self.poses[-2])))
            path_length = float(np.sum(self.seg_dists))
        else:
            path_length = 0.0
        print(f'    ts {self.ts} | #pc {len(self.poses)} |',
              f'path length {path_length:.2f}')
        self.ts += 1

    # ------------------------------------------------------------------
    # Painted-count checks (deferred: the host does not wait per frame)
    # ------------------------------------------------------------------
    def _queue_painted(self, n_valid) -> None:
        host = n_valid.to('cpu', non_blocking=True)
        landed = None
        if self.device.type == 'cuda':
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(self.device))
        with self._painted_lock:
            self._painted_pending.append((host, landed))

    def check_painted(self) -> None:
        """Read the painted counts of the frames integrated so far and
        raise if one exceeded the per-frame cap (points must not be
        dropped silently). Each count is taken by one caller, under the
        lock; its wait (span 'sync.painted', counter 'host_syncs') is
        outside it."""
        cap = self.accum_cfg.painted_cap
        while True:
            with self._painted_lock:
                if not self._painted_pending:
                    return
                host, landed = self._painted_pending.popleft()
            with profiling.span('sync.painted'):
                if landed is not None:
                    landed.synchronize()
                    profiling.count('host_syncs')
            n = int(host)
            with self._painted_lock:
                self.max_painted = max(self.max_painted, n)
            if n > cap:
                raise RuntimeError(
                    f'Painted-point overflow: frame produced {n} > cap '
                    f'{cap}; raise AccumConfig.max_painted_points_per_frame '
                    '(points must not be silently dropped).')

    def _harvested(self) -> None:
        """The painted counts of every integrated frame are checked before
        the samples are returned."""
        self.check_painted()

    # ------------------------------------------------------------------
    # Trajectories and lanes for BEV generation
    # ------------------------------------------------------------------
    def _other_trajs(self, present_idx, gen_future):
        past, future, full = self.tracker.get_split_dyn_obj_trajs(
            present_idx)

        def to_np(ts):
            return [np.asarray(t, np.float64) for t in ts]

        if gen_future:
            return to_np(past), to_np(future), to_np(full)
        return to_np(past), [], []

    def _gt_lanes(self):
        if self.get_gt_lanes and self.gt_lane_poses is not None:
            return self.gt_lane_poses
        return None

    def get_split_dyn_obj_trajs(self, split_idx, skip_ego_traj=True):
        return self.tracker.get_split_dyn_obj_trajs(split_idx)

    def get_dyn_obj_trajs(self, ts_start: int = 0, ts_end=None,
                          skip_ego_traj: bool = True):
        return self.tracker.get_dyn_obj_trajs(
            ts_start, ts_end,
            ego_poses=None if skip_ego_traj else self.poses)

    def viz_gt_lane_map(self, file_path: str = 'gt_lane_map.png',
                        grid_spacing: float = 50):
        """Plot the GT lanes to a PNG (matplotlib, imported here)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        x0 = y0 = np.inf
        x1 = y1 = -np.inf
        for lane in self.gt_lane_poses or []:
            plt.plot(lane[:, 0], lane[:, 1])
            x0, y0 = min(x0, lane[:, 0].min()), min(y0, lane[:, 1].min())
            x1, y1 = max(x1, lane[:, 0].max()), max(y1, lane[:, 1].max())
        if np.isfinite(x0):
            x0, y0 = (x0 // 10) * 10, (y0 // 10) * 10
            x1 = (x1 // 10) * 10 + grid_spacing
            y1 = (y1 // 10) * 10 + grid_spacing
            plt.grid()
            plt.xticks(np.arange(x0, x1, grid_spacing))
            plt.yticks(np.arange(y0, y1, grid_spacing))
        plt.savefig(file_path)
        plt.clf()
        plt.close()
