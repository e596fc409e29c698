"""Fixed-capacity device point buffer and the frame painting pipeline.

Counterpart of accum/buffer.py. The buffer is a slotted (F, N, 10) tensor
of world-frame points plus validity; frame ``g`` occupies slot ``g % F``.
Per-point layout (config.PT_*): [x, y, z, intensity, r, g, b, sem, inst,
dyn]. Frames are written in place (one copy into the slot instead of a
new buffer per frame).
"""
from __future__ import annotations

import dataclasses

import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.ops import geometry as geo


@dataclasses.dataclass
class BufferState:
    """Accumulated semantic point cloud in the world frame."""
    points: torch.Tensor      # (F, N, 10) float32
    valid: torch.Tensor       # (F, N) bool
    frame_ids: torch.Tensor   # (F,) int32, -1 = empty slot
    inst_dyn: torch.Tensor    # (MAX_INST,) float32 per-instance dyn flag


def init_state(max_frames: int, max_points: int, max_instances: int,
               device) -> BufferState:
    return BufferState(
        points=torch.zeros((max_frames, max_points, cfg.PT_DIM),
                           dtype=torch.float32, device=device),
        valid=torch.zeros((max_frames, max_points), dtype=torch.bool,
                          device=device),
        frame_ids=torch.full((max_frames,), -1, dtype=torch.int32,
                             device=device),
        inst_dyn=torch.zeros((max_instances,), dtype=torch.float32,
                             device=device))


def insert_frame(state: BufferState, pts, valid, frame_id: int) -> None:
    """Write one painted frame (N,10) + valid (N,) into its ring slot, in
    place. ``frame_id`` is the host-side global frame id."""
    slot = frame_id % state.frame_ids.shape[0]
    state.points[slot].copy_(pts)
    state.valid[slot].copy_(valid)
    state.frame_ids[slot].fill_(frame_id)   # a kernel, not a host copy


def set_instance_dyn(state: BufferState, inst_idxs, dyn_flags) -> None:
    """Raise the per-instance dynamic flags in place: inst_dyn[i] =
    max(inst_dyn[i], flag) for each (i, flag), ids may repeat. The raster
    folds the table into every stored point of the instance."""
    state.inst_dyn.scatter_reduce_(0, inst_idxs.to(torch.int64),
                                   dyn_flags.to(torch.float32), 'amax',
                                   include_self=True)


def compact_rows(painted, valid, cap_out):
    """Stable-move valid rows to the front and truncate to ``cap_out``.

    Returns (painted (cap_out, D), valid (cap_out,), n_valid 0-d tensor).
    Callers must check n_valid <= cap_out: overflow must not silently drop
    points."""
    order = torch.sort((~valid).to(torch.int32), stable=True).indices
    out = painted[order[:cap_out]]
    n_valid = valid.sum()
    valid_out = torch.arange(cap_out, device=valid.device) < n_valid
    return out, valid_out, n_valid


def compact_window(state: BufferState, wmin, cap_out: int):
    """Copy the live-window rows of the ring into one dense prefix of
    ``cap_out`` rows: a masked prefix copy in slot order (each slot's
    valid rows are a prefix, since insert_frame stores compact_rows
    output). ``wmin`` is the window start (0-d tensor).

    Returns (points (cap_out, D), frame_ids (cap_out,), valid (cap_out,),
    n_live 0-d tensor). Callers must check n_live <= cap_out: rows past
    the cap are parked in a slack row and dropped."""
    F, N, D = state.points.shape
    live = (state.frame_ids >= wmin) & (state.frame_ids >= 0)       # (F,)
    keep = (state.valid & live[:, None]).reshape(-1)
    dest = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep & (dest < cap_out), dest, cap_out)
    out_p = torch.zeros((cap_out + 1, D), dtype=torch.float32,
                        device=state.points.device)
    out_p.index_copy_(0, dest, state.points.reshape(F * N, D))
    out_f = torch.full((cap_out + 1,), -1, dtype=torch.int32,
                       device=state.points.device)
    out_f.index_copy_(0, dest, state.frame_ids.repeat_interleave(N))
    n_live = keep.sum()
    valid = torch.arange(cap_out, device=keep.device) < n_live
    return out_p[:cap_out], out_f[:cap_out], valid, n_live


def paint_frame_camera(pc, valid, rgb_img, semseg, P_velo_frame,
                       T_world_velo, filters):
    """Project lidar (N,4) into the camera, gather RGB (H,W,3) and the
    class map (H,W), drop filtered classes, move to the world frame.
    Returns (painted (N,10), valid_out (N,))."""
    feats = torch.cat([rgb_img, semseg[..., None].to(torch.float32)], dim=-1)
    gathered, proj_mask = geo.paint_from_image(pc[:, :3], P_velo_frame,
                                               feats)
    sem = gathered[:, 3]
    valid_out = valid & proj_mask & geo.semseg_filter_mask(sem, filters)
    world_xyz = geo.homo_transform(T_world_velo, pc[:, :3])
    zeros = torch.zeros_like(sem)[:, None]
    painted = torch.cat([world_xyz, pc[:, 3:4], gathered[:, :3],
                         sem[:, None], zeros, zeros], dim=1)
    return painted, valid_out


def paint_frame_multicam(pc, valid, cam_idx, imgs, semsegs, T_world_ego,
                         inst_remap, filters):
    """Paint pre-projected multi-camera points (NuScenes layout): the
    nearest pixel's RGB and class from each point's camera, all cameras in
    one gather; drop unprojected points and filtered classes; intensity
    / 255; ego -> world.

    Args:
      pc: (N,7) [x, y, z ego frame, intensity, u, v, frame_inst_idx (-1 =
        none)].
      valid: (N,) padding mask.
      cam_idx: (N,) int camera per point, -1 = no projection.
      imgs: (C,H,W,3) float32 images; semsegs: (C,H,W) int class maps.
      T_world_ego: (4,4) ego -> world.
      inst_remap: (K,) int global instance id of frame_inst_idx + 1 (0 =
        untracked; accum/tracking.InstanceTracker).

    Returns (painted (N,10), valid_out (N,))."""
    C, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    # Round half to even, as jnp.round; the clamp in float before the cast
    # gives the same index as XLA's saturating cast followed by a clip.
    u = torch.round(pc[:, 4]).clamp(0, W - 1).to(torch.int64)
    v = torch.round(pc[:, 5]).clamp(0, H - 1).to(torch.int64)
    ci = cam_idx.clamp(0, C - 1).to(torch.int64)
    rgb = imgs[ci, v, u]
    sem = semsegs[ci, v, u].to(torch.float32)
    valid_out = valid & (cam_idx >= 0) & geo.semseg_filter_mask(sem, filters)
    world_xyz = geo.homo_transform(T_world_ego, pc[:, :3])
    inten = pc[:, 3:4] / 255.0
    # The float -> int cast truncates toward zero on both sides; clamping
    # to [-1, K] first keeps every in-range index and the cast defined.
    K = inst_remap.shape[0]
    fi = (pc[:, 6].clamp(-1, K).to(torch.int64) + 1).clamp(0, K - 1)
    inst = inst_remap[fi].to(torch.float32)
    zeros = torch.zeros_like(sem)[:, None]
    painted = torch.cat([world_xyz, inten, rgb, sem[:, None], inst[:, None],
                         zeros], dim=1)
    return painted, valid_out


def paint_frame_gt(pc, valid, sem_gt, T_world_velo, filters):
    """GT-semantics paint: zero RGB, drop filtered classes."""
    sem = sem_gt.to(torch.float32)
    valid_out = valid & geo.semseg_filter_mask(sem, filters)
    world_xyz = geo.homo_transform(T_world_velo, pc[:, :3])
    zeros = torch.zeros_like(sem)[:, None]
    painted = torch.cat([world_xyz, pc[:, 3:4], zeros, zeros, zeros,
                         sem[:, None], zeros, zeros], dim=1)
    return painted, valid_out
