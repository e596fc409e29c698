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


def paint_frame_gt(pc, valid, sem_gt, T_world_velo, filters):
    """GT-semantics paint: zero RGB, drop filtered classes."""
    sem = sem_gt.to(torch.float32)
    valid_out = valid & geo.semseg_filter_mask(sem, filters)
    world_xyz = geo.homo_transform(T_world_velo, pc[:, :3])
    zeros = torch.zeros_like(sem)[:, None]
    painted = torch.cat([world_xyz, pc[:, 3:4], zeros, zeros, zeros,
                         sem[:, None], zeros, zeros], dim=1)
    return painted, valid_out
