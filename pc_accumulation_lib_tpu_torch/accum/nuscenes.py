"""NuScenes estimated-pose (ICP) accumulator.

Counterpart of accum/nuscenes.py: the oracle variant's 6-camera paint
(accum/nuscenes_oracle.paint_insert_multicam, no instance remap), ICP
ego-motion on the ego-frame cloud chained into the world pose, and
memory-horizon eviction. The host reads each frame's world pose and
painted count after its device work.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.accum.base import (
    SemanticPointCloudAccumulator)
from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
    check_wire, decode_multicam, encode_multicam_obs, paint_insert_multicam)
from pc_accumulation_lib_tpu_torch.ops import geometry
from pc_accumulation_lib_tpu_torch.ops import icp as icp_ops


class NuScenesSemanticPointCloudAccumulator(SemanticPointCloudAccumulator):

    bev_ref_frame = 'latest'

    def __init__(self, horizon_dist: float, icp_threshold: float,
                 semseg_model=None,
                 semseg_filters=cfg.DEFAULT_SEMSEG_FILTERS,
                 sem_idxs: Optional[dict] = None, use_gt_sem: bool = False,
                 bev_params: Optional[dict] = None,
                 loc: Optional[str] = None,
                 accum_cfg: Optional[cfg.AccumConfig] = None,
                 icp_cfg: Optional[cfg.ICPConfig] = None,
                 seed: Optional[int] = None,
                 img_transfer: str = 'rgb8',
                 transfer_dtype: str = 'float32', *, device='cuda'):
        """Arguments as the JAX package's, plus ``device`` (the card unless
        the caller passes 'cpu'); the wires as the oracle accumulator's."""
        if use_gt_sem:
            raise NotImplementedError()
        check_wire(img_transfer, transfer_dtype)
        self.img_transfer = img_transfer
        self.transfer_dtype = transfer_dtype
        super().__init__(horizon_dist, icp_threshold, semseg_model,
                         semseg_filters, sem_idxs, use_gt_sem, bev_params,
                         accum_cfg, seed, device=device)
        self.map = loc
        self.ego_global_xs: List[float] = []
        self.ego_global_ys: List[float] = []
        self.pose_z_origin = 1.0
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
        self._T_world_dev = None
        self._T_world_velo_last = np.eye(4)

    def integrate(self, observations: list) -> int:
        """Integrate observation dicts with eviction; returns the number of
        evicted frames."""
        num_removed = 0
        for obs in observations:
            self._integrate_one(obs)
            if len(self.poses) > 1:
                idx, path_length = self.remove_observations()
                num_removed += idx
                print(f'    #pc {len(self.poses)} |',
                      f'path length {path_length:.2f}')
        return num_removed

    @torch.no_grad()
    def _fused_step(self, pc_wire, valid, cam_idx, img_parts, first: bool):
        """One frame's device work: wire decode, ICP preprocess and
        register against the previous cloud (on the decoded points), pose
        chain, paint and insert. Returns the packed (17,) [T_world(16),
        n_painted] and the class maps."""
        pc_pad, imgs = decode_multicam(pc_wire, img_parts,
                                       self.accum_cfg.max_points_per_frame)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        new_cloud = self._icp_pre(pc_pad[:, :3], valid)
        if first:
            T_new_prev = eye
        else:
            T_new_prev, _, _ = self._icp_reg(self._icp_prev_cloud, new_cloud,
                                             eye, self.icp_cfg.max_corr_dist)
        T_world = self._T_world_dev @ geometry.rigid_inverse(T_new_prev)
        # No instances: the instance column stays 0.
        no_inst = torch.zeros((2,), dtype=torch.int32, device=self.device)
        n_valid, semsegs = paint_insert_multicam(
            self.state, self.semseg_model, self.semseg_filters,
            self.accum_cfg.painted_cap, pc_pad, valid, cam_idx, imgs,
            T_world, no_inst, self.frame_count)
        self._icp_prev_cloud = new_cloud
        self._T_world_dev = T_world
        return torch.cat([T_world.reshape(-1),
                          n_valid.to(torch.float32)[None]]), semsegs

    def _integrate_one(self, obs: dict):
        _, pc_wire, valid, cam_idx, parts = encode_multicam_obs(
            obs, self.accum_cfg.max_points_per_frame, self.img_transfer,
            self.transfer_dtype)
        first = self._icp_prev_cloud is None
        if first:
            self._T_world_dev = torch.as_tensor(
                self._T_world_velo_last, dtype=torch.float32,
                device=self.device)
        packed, semsegs = self._fused_step(
            self._to_device(pc_wire), self._to_device(valid),
            self._to_device(cam_idx),
            tuple(self._to_device(p) for p in parts), first)
        self.frame_count += 1
        vec = packed.cpu().numpy().astype(np.float64)
        T_world = vec[:16].reshape(4, 4)
        n_painted = int(vec[16])
        if n_painted > self.accum_cfg.painted_cap:
            raise RuntimeError(
                f'Painted-point overflow: {n_painted} > cap '
                f'{self.accum_cfg.painted_cap}.')
        self._T_world_velo_last = T_world
        self._append_frame_meta(T_world, obs['images'], semsegs)
        # Lift the stored pose origin above the ground.
        self.poses[-1][2] += self.pose_z_origin
        self.ego_global_xs.append(obs.get('ego_global_x', 0.0))
        self.ego_global_ys.append(obs.get('ego_global_y', 0.0))

    def get_rgb(self, idx: Optional[int] = None) -> list:
        """The image list of frame ``idx`` itself (not wrapped in a list,
        unlike the base accumulator's)."""
        return self.rgbs if idx is None else self.rgbs[idx]

    def get_semseg(self, idx: Optional[int] = None) -> list:
        return self.semsegs if idx is None else self.semsegs[idx]
