"""KITTI-360 accumulator: 1 forward camera + 360-degree lidar, ICP
ego-motion, and the step() path that integrates frames and generates
augmented BEV samples.

Counterpart of accum/kitti360.py. Each frame runs one integrate function
on the device (dequant, ICP preprocess + register, pose chain, semseg,
camera or GT paint, compact_rows, ring insert, eviction window, raster
pose parameters) that reads and writes the accumulator's device state in
place. The pose chain, the eviction window and the raster's pose
parameters stay on the device between frames; the host reads one packed
(37,) vector per frame for its bookkeeping, inside step()'s finalize.

With ``AccumConfig.compact_rungs`` each step sweeps the smallest rung of
a ladder that a host-side bound on the live rows proves sufficient, and
``prewarm_rungs`` runs every rung's pieces once in warm-up.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.accum import buffer
from pc_accumulation_lib_tpu_torch.accum.base import (
    SemanticPointCloudAccumulator)
from pc_accumulation_lib_tpu_torch.ops import geometry
from pc_accumulation_lib_tpu_torch.ops import icp as icp_ops
from pc_accumulation_lib_tpu_torch.ops import imgcodec
from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
from pc_accumulation_lib_tpu_torch.utils import profiling


def window_update(seg_ring, ws, T_world, T_world_prev, frame_id: int,
                  horizon: float, first: bool):
    """Device mirror of the host memory-horizon eviction: write this
    frame's path segment into ``seg_ring`` (in place, slot frame_id % R),
    then advance the window start past the horizon (the first index where
    the cumulative path exceeds the overshoot).

    Returns (new window start, pre-eviction path length, ring_overflow).
    ring_overflow = 1 means this frame's write overwrote a segment still
    inside the live window (it spans more than R frames), so the host
    raises."""
    zero = torch.zeros((), dtype=torch.float32, device=seg_ring.device)
    if first:
        return ws, zero, zero
    R = seg_ring.shape[0]
    overflow = (frame_id - ws > R).to(torch.float32)
    seg_ring[frame_id % R] = torch.linalg.vector_norm(
        T_world[:3, 3] - T_world_prev[:3, 3])
    gids = ws + 1 + torch.arange(R, dtype=torch.int32, device=ws.device)
    live = gids <= frame_id
    segs = torch.where(live, seg_ring[torch.remainder(gids, R)], 0.0)
    path = segs.sum()
    cond = (torch.cumsum(segs, 0) - (path - horizon) > 0.) & live
    first_true = torch.argmax(cond.to(torch.int32)).to(torch.int32)
    idx = torch.where(path > horizon, first_true, 0)
    return ws + idx, path, overflow


def pose_params_vec(T_world, T_world_prev, ws, frame_id: int):
    """(22,) pose half of the raster parameters for the 'latest-1' present
    policy: [T_ref_world(16), bev_coords(3), window_min, window_max,
    present_frame]. T_ref_world is the rigid inverse in float32: a general
    inverse loses ~0.4 m at 100 m of travel."""
    R, t = T_world[:3, :3], T_world[:3, 3]
    bev_coords = R.T @ (T_world_prev[:3, 3] - t)
    f = torch.full((), float(frame_id), dtype=torch.float32,
                   device=T_world.device)
    return torch.cat([geometry.rigid_inverse(T_world).reshape(-1),
                      bev_coords,
                      torch.stack([ws.to(torch.float32), f, f - 1.0])])


class DeviceObs(NamedTuple):
    """An uploaded observation (upload_obs): ``aux`` is the camera image
    (camera path: a tensor, or the yuv wire's tuple of tensors) or the
    padded per-point GT labels (GT path); ``rgb_host`` keeps the host
    image for the frame bookkeeping; ``frame`` is the frame id of its
    spans (profiling.new_frame)."""
    rgb_host: object
    pc_pad: torch.Tensor
    valid: torch.Tensor
    aux: object
    frame: int


class Kitti360SemanticPointCloudAccumulator(SemanticPointCloudAccumulator):

    def __init__(self, horizon_dist: float, calib_params: dict,
                 icp_threshold: float, semseg_model=None,
                 semseg_filters=cfg.DEFAULT_SEMSEG_FILTERS,
                 sem_idxs: Optional[dict] = None, use_gt_sem: bool = False,
                 bev_params: Optional[dict] = None,
                 accum_cfg: Optional[cfg.AccumConfig] = None,
                 icp_cfg: Optional[cfg.ICPConfig] = None,
                 seed: Optional[int] = None,
                 transfer_dtype: str = 'float32',
                 img_transfer: Optional[str] = None, *,
                 device='cuda'):
        """Arguments as the JAX package's, plus ``device`` (the card
        unless the caller passes 'cpu'). ``semseg_model``
        is a models.semseg.SemSegTorch on the same device.
        ``transfer_dtype='quantized'`` uploads points packed at 7 B/point
        (xyz as 5 mm int16, intensity as uint8 at the same x200 scale) and
        the image as uint8, decoded on the device. ``img_transfer``
        'yuv420' or 'yuv420h' (ops/imgcodec.py) encodes the image on the
        host and decodes it at the head of the frame step; None means
        'rgb8'."""
        super().__init__(horizon_dist, icp_threshold, semseg_model,
                         semseg_filters, sem_idxs, use_gt_sem, bev_params,
                         accum_cfg, seed, device=device)
        if img_transfer not in (None, 'rgb8') + imgcodec.WIRES:
            raise ValueError(f'img_transfer={img_transfer!r}')
        self.img_transfer = img_transfer or 'rgb8'
        # Compact-rung ladder (AccumConfig.compact_rungs): _live_ub is a
        # host-side upper bound on the live rows, raised by painted_cap
        # per dispatched frame and tightened a step behind from the
        # counted rows; _cum_growth dates the bound so the tightening
        # counts the frames dispatched since. The dispatching thread and
        # a finalize on a worker thread both update it (_ub_lock).
        self._live_ub = 0
        self._cum_growth = 0
        self._ub_lock = threading.Lock()
        self._rungs = None
        self.rungs_used = {}         # rung -> steps that swept it
        ccap = self.accum_cfg.compact_cap
        if ccap and self.accum_cfg.compact_rungs:
            rungs = sorted(set(int(r) for r in self.accum_cfg.compact_rungs
                               if r < ccap))
            if any(r <= 0 for r in rungs):
                raise ValueError('compact_rungs must be positive')
            self._rungs = tuple(rungs) + (ccap,)
        if transfer_dtype not in ('float32', 'quantized'):
            raise ValueError(f'transfer_dtype={transfer_dtype!r}')
        self.transfer_dtype = transfer_dtype
        self.P_velo_frame = torch.as_tensor(
            np.asarray(calib_params['p_velo_frame'], np.float32),
            device=self.device)
        self.icp_cfg = icp_cfg or cfg.ICPConfig(max_corr_dist=icp_threshold)
        self._icp_pre = icp_ops.make_preprocess_fn(
            self.icp_cfg.max_downsampled, self.icp_cfg.normal_neighbors)
        if self.icp_cfg.coarse_to_fine:
            self._icp_reg = icp_ops.make_coarse_to_fine_register_fn(
                self.icp_cfg.num_iters,
                coarse_factor=self.icp_cfg.coarse_factor)
        else:
            self._icp_reg = icp_ops.make_register_fn(self.icp_cfg.num_iters)
        self._icp_prev_cloud = None
        self._T_world_velo_last = np.eye(4)
        self._T_new_prev_last = np.eye(4)
        # Device state threaded between frames (set at the first frame).
        self._T_world_dev = None
        self._T_new_prev_dev = None
        self._seg_ring_dev = None    # seg_ring[g % F]: segment ending at g
        self._ws_dev = None          # window start, 0-d int32
        self._pose_vec_dev = None    # (22,) raster pose parameters
        self.max_live_rows = 0       # compact_window telemetry (step())
        self.upload_bytes_total = 0  # host -> device observation bytes
        self.upload_frames = 0

    # ------------------------------------------------------------------
    # Upload
    # ------------------------------------------------------------------
    def _pad_pc(self, pc: np.ndarray):
        """Host padding (and quantized packing) of one (N,4) cloud to
        max_points_per_frame rows. Returns numpy (pc_pad, valid)."""
        n_cap = self.accum_cfg.max_points_per_frame
        n = pc.shape[0]
        if n > n_cap:
            raise RuntimeError(
                f'Frame has {n} points > max_points_per_frame={n_cap}; '
                'raise AccumConfig.max_points_per_frame.')
        if self.transfer_dtype == 'quantized':
            xyz = np.zeros((n_cap, 3), np.int16)
            xyz_scaled = np.round(pc[:, :3] * 200.0)
            if n and (xyz_scaled.min() < -32768 or xyz_scaled.max() > 32767):
                raise ValueError(
                    f'quantized upload: coordinate range '
                    f'[{pc[:, :3].min():.4g}, {pc[:, :3].max():.4g}] m '
                    f'outside the i16-representable +-163.84 m')
            xyz[:n] = xyz_scaled
            inten = np.zeros(n_cap, np.uint8)
            scaled = np.round(pc[:n, 3] * 200.0)
            if n and (scaled.min() < 0 or scaled.max() > 255):
                raise ValueError(
                    f'quantized upload: intensity range '
                    f'[{pc[:n, 3].min():.4g}, {pc[:n, 3].max():.4g}] '
                    f'outside the u8-representable [0, 1.275]')
            inten[:n] = scaled
            out = np.concatenate([xyz.view(np.uint8).reshape(-1), inten])
        else:
            out = np.zeros((n_cap, pc.shape[1]), np.float32)
            out[:n] = pc
        return out, np.arange(n_cap) < n

    def upload_obs(self, obs) -> DeviceObs:
        """Start the host->device upload of one (rgb, pc, sem_gt)
        observation; integrate/step accept the result in its place. Span
        'upload' (a new frame id); counters 'upload.bytes' and the pinned
        allocations."""
        if isinstance(obs, DeviceObs):
            return obs
        frame = profiling.new_frame()
        with profiling.span('upload', frame), profiling.pinned_allocs():
            rgb, pc, sem_gt = obs
            pc = np.asarray(pc, np.float32)
            pc_pad, valid = self._pad_pc(pc)
            if self.use_gt_sem or self.semseg_model is None:
                aux = np.zeros(self.accum_cfg.max_points_per_frame,
                               np.float32)
                aux[:pc.shape[0]] = np.asarray(sem_gt).reshape(-1)
            else:
                aux = self._prep_rgb(rgb)
            if isinstance(aux, tuple):
                aux_bytes = sum(p.nbytes for p in aux)
                aux_dev = tuple(self._to_device(p) for p in aux)
            else:
                aux_bytes, aux_dev = aux.nbytes, self._to_device(aux)
            nbytes = pc_pad.nbytes + valid.nbytes + aux_bytes
            self.upload_bytes_total += nbytes
            self.upload_frames += 1
            profiling.count('upload.bytes', nbytes)
            return DeviceObs(rgb, self._to_device(pc_pad),
                             self._to_device(valid), aux_dev, frame)

    def _prep_rgb(self, rgb):
        """The host image on its wire: the yuv tuple, uint8 (quantized)
        or float32."""
        arr = np.asarray(rgb)[..., :3]
        if self.img_transfer in imgcodec.WIRES:
            return imgcodec.encode_wire(arr.astype(np.uint8),
                                        self.img_transfer)
        if self.transfer_dtype == 'quantized':
            return arr.astype(np.uint8)
        return arr.astype(np.float32)

    # ------------------------------------------------------------------
    # Per-frame device work
    # ------------------------------------------------------------------
    def _dequant(self, pc_pad):
        if pc_pad.dtype != torch.uint8:
            return pc_pad
        n_cap = self.accum_cfg.max_points_per_frame
        xyz = pc_pad[:6 * n_cap].view(torch.int16).reshape(n_cap, 3)
        inten = pc_pad[6 * n_cap:]
        return torch.cat([xyz.to(torch.float32),
                          inten.to(torch.float32)[:, None]], 1) * (1.0 / 200.0)

    @torch.no_grad()
    def _integrate_frame(self, pc_pad, valid, aux, frame_id: int,
                         first: bool):
        """One frame's device work; updates the device state in place and
        returns the packed (37,) vector [T_world_velo(16), T_new_prev(16),
        n_painted, icp_n_corr, window_start, path_len, ring_overflow].
        Device spans at its stages: 'dequant', 'icp.pre', 'icp.register',
        'decode', 'semseg', 'paint', 'insert', 'window'."""
        dev = self.device
        span = profiling.span
        with span('dequant', device=True):
            pc = self._dequant(pc_pad)
        with span('icp.pre', device=True):
            new_cloud = self._icp_pre(pc[:, :3], valid)
        if first:
            T_new_prev = torch.eye(4, dtype=torch.float32, device=dev)
            n_corr = torch.zeros((), dtype=torch.float32, device=dev)
        else:
            init = (self._T_new_prev_dev if self.icp_cfg.warm_start
                    else torch.eye(4, dtype=torch.float32, device=dev))
            with span('icp.register', device=True):
                T_new_prev, _, n_corr = self._icp_reg(
                    self._icp_prev_cloud, new_cloud, init,
                    self.icp_cfg.max_corr_dist)
        T_world_prev = self._T_world_dev
        T_world = T_world_prev @ geometry.rigid_inverse(T_new_prev)
        filters = self.semseg_filters
        if self.use_gt_sem or self.semseg_model is None:
            with span('paint', device=True):
                painted, valid_out = buffer.paint_frame_gt(
                    pc, valid, aux, T_world, filters)
        else:
            with span('decode', device=True):
                rgb_img = (imgcodec.decode_wire(aux)
                           if isinstance(aux, tuple)
                           else aux.to(torch.float32))
            with span('semseg', device=True):
                semseg = self.semseg_model.predict(rgb_img[None])[0]
            with span('paint', device=True):
                painted, valid_out = buffer.paint_frame_camera(
                    pc, valid, rgb_img, semseg, self.P_velo_frame, T_world,
                    filters)
        with span('insert', device=True):
            painted, valid_out, n_valid = buffer.compact_rows(
                painted, valid_out, self.accum_cfg.painted_cap)
            buffer.insert_frame(self.state, painted, valid_out, frame_id)
        with span('window', device=True):
            ws_new, path, ring_ovf = window_update(
                self._seg_ring_dev, self._ws_dev, T_world, T_world_prev,
                frame_id, float(self.horizon_dist), first)
            self._pose_vec_dev = pose_params_vec(T_world, T_world_prev,
                                                 ws_new, frame_id)
        self._icp_prev_cloud = new_cloud
        self._T_world_dev = T_world
        self._T_new_prev_dev = T_new_prev
        self._ws_dev = ws_new
        return torch.cat([
            T_world.reshape(-1), T_new_prev.reshape(-1),
            torch.stack([n_valid.to(torch.float32), n_corr,
                         ws_new.to(torch.float32), path, ring_ovf])])

    def _dispatch_obs(self, obs):
        """Queue one observation's device work (span 'integrate'); returns
        a zero-arg closure that waits for its packed vector (span
        'sync.step_vec') and does the host bookkeeping."""
        rgb, pc_pad, valid, aux, frame = self.upload_obs(obs)
        self.last_frame = frame
        with profiling.span('integrate', frame):
            return self._dispatch_frame(rgb, pc_pad, valid, aux)

    def _dispatch_frame(self, rgb, pc_pad, valid, aux):
        first = self._icp_prev_cloud is None
        if first:
            dev = self.device
            self._T_world_dev = torch.as_tensor(
                self._T_world_velo_last, dtype=torch.float32, device=dev)
            self._T_new_prev_dev = torch.as_tensor(
                self._T_new_prev_last, dtype=torch.float32, device=dev)
            self._seg_ring_dev = torch.zeros(
                (self.accum_cfg.max_frames,), dtype=torch.float32,
                device=dev)
            self._ws_dev = torch.full((), self.window_start,
                                      dtype=torch.int32, device=dev)
        packed = self._integrate_frame(pc_pad, valid, aux, self.frame_count,
                                       first)
        self.frame_count += 1     # frame id reserved at dispatch
        # The frame adds at most painted_cap live rows; eviction only
        # takes rows away.
        cap_g = self.accum_cfg.painted_cap
        with self._ub_lock:
            self._live_ub = min(self._live_ub + cap_g,
                                self.accum_cfg.max_frames * cap_g)
            self._cum_growth += cap_g
        packed_host = packed.to('cpu', non_blocking=True)
        landed = None
        if self.device.type == 'cuda':
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(self.device))

        def fetch():
            with profiling.span('sync.step_vec'):
                if landed is not None:
                    landed.synchronize()
                    profiling.count('host_syncs')
            vec = packed_host.numpy().astype(np.float64)
            T_world_velo = vec[:16].reshape(4, 4)
            T_new_prev = vec[16:32].reshape(4, 4)
            n_painted = int(vec[32])
            if n_painted > self.accum_cfg.painted_cap:
                raise RuntimeError(
                    f'Painted-point overflow: frame produced {n_painted} > '
                    f'cap {self.accum_cfg.painted_cap}; raise '
                    'AccumConfig.max_painted_points_per_frame (points must '
                    'not be silently dropped).')
            if vec[36] != 0.0:
                raise RuntimeError(
                    'Eviction-ring overflow: the live memory-horizon window '
                    f'spans more than max_frames={self.accum_cfg.max_frames} '
                    'frames, so the device seg_ring would wrap and drop path '
                    'segments. Raise AccumConfig.max_frames to cover '
                    'horizon_dist at the slowest expected speed.')
            self._T_world_velo_last = T_world_velo
            self._T_new_prev_last = T_new_prev
            self._append_frame_meta(T_world_velo, rgb, None)
            if len(self.poses) > 1:
                self.seg_dists.append(self.dist(
                    np.array(self.poses[-1]), np.array(self.poses[-2])))
            idx = int(vec[34]) - self.window_start
            if idx > 0:
                self._drop_oldest(idx)
            return idx

        return fetch

    # ------------------------------------------------------------------
    # Entry points
    # ------------------------------------------------------------------
    def integrate(self, observations: list, async_fetch: bool = False):
        """Integrate observations [(rgb, pc, sem_gt) or DeviceObs, ...];
        returns the number of evicted frames, or with ``async_fetch`` a
        zero-arg callable that does the host bookkeeping and returns it
        (all device work is queued first)."""
        handles = [self._dispatch_obs(obs) for obs in observations]

        def finalize() -> int:
            return sum(h() for h in handles)

        return finalize if async_fetch else finalize()

    def obs2sem_vec_space(self, rgb, pc: np.ndarray,
                          sem_gt: Optional[np.ndarray] = None):
        """Paint one observation into the world-frame buffer through the
        frame step, as integrate([(rgb, pc, sem_gt)]) does (ICP against
        the previous frame, the pose chain, eviction); the reference's
        per-frame call. Returns (None, pose, None, T_new_prev): the newest
        world-frame ego position and the transform from the previous ego
        frame to the new one (T_world_k = T_world_{k-1} @
        inv(T_new_prev))."""
        self._dispatch_obs((rgb, pc, sem_gt))()
        return None, self.poses[-1], None, self._T_new_prev_last

    def _pick_rung(self, ccap: int, ax: int) -> int:
        """The smallest rung the live-row bound proves sufficient (and,
        on a mesh, that the points axis divides); compact_cap otherwise."""
        if self._rungs is None:
            return ccap
        ub = min(self._live_ub, ccap)
        rung = next((r for r in self._rungs if r >= ub and r % ax == 0),
                    ccap)
        self.rungs_used[rung] = self.rungs_used.get(rung, 0) + 1
        return rung

    def step(self, observations: list, bev_num: int = 1,
             gen_future: bool = True, async_fetch: bool = False):
        """Integrate ``observations`` and generate ``bev_num`` augmented BEV
        samples at the 'latest-1' present policy (present_idx =
        len(poses) - 2). All device work is queued before the first host
        wait. Returns the list of BEV dicts, or with ``async_fetch`` a
        zero-arg callable yielding it (the host bookkeeping, the checks and
        the fetches happen in it, so a worker thread can drain a step while
        the next one is dispatched).

        Without augmentation the rotation is heading-aligned, which needs
        the host poses: step() is then integrate() followed by
        generate_bev(present_idx=len(poses) - 2). With compact_cap unset
        each raster sweeps the whole flat buffer instead of the compacted
        live window; with compact_rungs, the smallest sufficient rung. On
        a mesh (bev_params['mesh']) the flat rows are scattered over its
        points axis once per step and each sample is the mesh engine's
        tuple-form raster (no prep)."""
        gen = self.sem_bev_generator
        if not gen.do_aug:
            integrate_fn = self.integrate(observations, async_fetch=True)

            def finalize_classic():
                integrate_fn()
                return self.generate_bev(present_idx=len(self.poses) - 2,
                                         bev_num=bev_num,
                                         gen_future=gen_future)

            return finalize_classic if async_fetch else finalize_classic()
        devs = [self.upload_obs(obs) for obs in observations]
        frame = devs[-1].frame if devs else self.last_frame
        with profiling.span('step', frame):
            handle = self._dispatch_step(devs, bev_num, gen_future)

        def finalize():
            with profiling.span('harvest', frame):
                return handle()

        return finalize if async_fetch else finalize()

    def _dispatch_step(self, devs, bev_num, gen_future):
        """step()'s device work and copies, with spans 'integrate',
        'prep', 'raster', 'pack' and 'fetch'; returns its finalize (spans
        'sync.step_vec', 'sync.live_rows' and the generator's)."""
        gen = self.sem_bev_generator
        # Size the previous steps' sparse fetches first: their copies
        # queue ahead of everything this step enqueues.
        gen.resolve_ready_fetches()
        handles = [self._dispatch_obs(d) for d in devs]
        ccap = self.accum_cfg.compact_cap
        ax = (1 if gen.mesh_raster is None
              else pmesh.axis_size(gen.mesh_raster.mesh, 'points'))
        n_live = None
        cum_at_dispatch = self._cum_growth
        with profiling.span('prep', device=True):
            if ccap:
                # Once-per-step live-window compaction: every raster sweeps
                # the rung's rows instead of max_frames * painted_cap.
                ccap = self._pick_rung(ccap, ax)
                flat_pts, pt_fids, flat_valid, n_live = (
                    buffer.compact_window(self.state, self._ws_dev, ccap))
                n_live = (n_live.to('cpu', non_blocking=True),
                          self._event())
            else:
                f, n, d = self.state.points.shape
                flat_pts = self.state.points.view(f * n, d)
                flat_valid = self.state.valid.view(f * n)
                pt_fids = self.state.frame_ids.repeat_interleave(n)
            prepped = None
            if gen.mesh_raster is not None:
                # Scatter the flat snapshot over the points axis once per
                # step; each of the bev_num rasters then takes only its
                # parameters.
                if flat_pts.shape[0] % ax:
                    raise ValueError(
                        'step() on a mesh: flat point count '
                        f'{flat_pts.shape[0]} must be divisible by the '
                        f'points-axis size {ax} — size '
                        'AccumConfig.compact_cap (or max_frames * '
                        'painted_cap) to a multiple of the mesh points '
                        'axis.')
                gen.mesh_raster.shard(flat_pts, flat_valid, pt_fids,
                                      self.state.inst_dyn)
            else:
                prepped = gen.prep_points(flat_pts, self.state.inst_dyn,
                                          self._pose_vec_dev)

        def trajs_fn():
            # Runs after the integrate fetches have synced the host poses.
            pi = len(self.poses) - 2
            poses_ref = self._poses_ref(self._ref_transform())
            bev_coords = poses_ref[pi]
            trajs = {'ego_traj_present': poses_ref[:pi] - bev_coords,
                     'other_trajs_present': []}
            if gen_future:
                trajs['ego_traj_future'] = poses_ref[pi:] - bev_coords
                trajs['ego_traj_full'] = poses_ref - bev_coords
                trajs['other_trajs_future'] = []
                trajs['other_trajs_full'] = []
            return trajs

        bev_handle = gen.generate_samples_device(
            flat_valid, pt_fids, self._pose_vec_dev, bev_num, gen_future,
            trajs_fn, prepped)

        def finalize():
            for h in handles:
                h()
            if n_live is not None:
                with profiling.span('sync.live_rows'):
                    if n_live[1] is not None:
                        n_live[1].synchronize()
                        profiling.count('host_syncs')
                nl = int(n_live[0])
                self.max_live_rows = max(self.max_live_rows, nl)
                if nl > ccap:
                    raise RuntimeError(
                        f'Live-window overflow: {nl} live buffer rows > the '
                        f'swept capacity {ccap} (compact_cap='
                        f'{self.accum_cfg.compact_cap}); raise '
                        'AccumConfig.compact_cap (points must not be '
                        'silently dropped).')
                # nl is exact for the state at this step's dispatch; the
                # frames dispatched since add at most painted_cap each.
                with self._ub_lock:
                    self._live_ub = min(
                        self._live_ub,
                        nl + (self._cum_growth - cum_at_dispatch))
            return bev_handle()

        return finalize

    def _event(self):
        """An event recorded on the current stream (None on the CPU)."""
        if self.device.type != 'cuda':
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @torch.no_grad()
    def prewarm_rungs(self, fetch_group: Optional[int] = None,
                      gen_future: bool = True, include_single: bool = True):
        """Run every compact rung's step() pieces once (compact_window,
        the prep and the grouped prepped raster, and with
        ``include_single`` the single-sample raster that bev_num=1 takes)
        on the current window with fixed draws, so the kernels' first-use
        build and the caching allocator's blocks come in warm-up and not
        at a rung crossing mid-run. The outputs are dropped; the
        accumulator's and the generator's state, RNG and counters stay as
        they were. Does nothing without rungs, before the first frame, or
        on a mesh."""
        gen = self.sem_bev_generator
        if (self._rungs is None or self._pose_vec_dev is None
                or gen.mesh_raster is not None):
            return
        G = max(1, gen.fetch_group if fetch_group is None else fetch_group)
        hf = np.inf if gen.height_filter is None else gen.height_filter
        aug = np.zeros((G, 9), np.float32)
        aug[:, 3] = 1.0                      # identity zoom
        aug[:, 5] = 1.0                      # warp a2 = 1
        aug[:, 7] = 1.0                      # warp b2 = 1
        aug[:, 8] = hf
        aug = torch.as_tensor(aug, device=self.device)
        gfn = gen.prepped_raster(grouped=True)
        sfn = gen.prepped_raster() if include_single else None
        for rung in self._rungs:
            pts, fids, valid, _ = buffer.compact_window(
                self.state, self._ws_dev, rung)
            ref, packed, packed2 = gen.prep_points(pts, self.state.inst_dyn,
                                                   self._pose_vec_dev)
            gfn(ref, valid, fids, packed, packed2, self._pose_vec_dev, aug,
                gen_future)
            if sfn is not None:
                sfn(ref, valid, fids, packed, packed2,
                    (self._pose_vec_dev, aug[0]), gen_future)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
