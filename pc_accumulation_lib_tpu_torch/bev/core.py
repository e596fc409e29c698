"""BEV raster on tensors.

Counterpart of bev/core.py with the dense float16 output. Two forms:

  * ``make_raster_fn``, the classic per-sample raster of the
    integrate() + generate_bev() path: world -> BEV-reference transform,
    rotate/translate/zoom, view and height masks, cell ids, the
    static/dynamic partition and the time splits over the flat point
    buffer, then the channel stats by the sort routes (ops/sort_raster)
    or the scatter spec (ops/rasterize), the dense warp and the
    road-marking transform, cast to one (S*7, P, P) float16 stack;
  * the step() form: ``make_prep_fn`` does the augmentation-invariant
    per-point work once per step (world -> BEV-reference transform, class
    masks, dyn partition, the two packed payload words), and each
    augmented sample then runs the prepped raster.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.ops import geometry as geo
from pc_accumulation_lib_tpu_torch.ops import rasterize as ras
from pc_accumulation_lib_tpu_torch.ops import sort_raster
from pc_accumulation_lib_tpu_torch.ops import warp as warp_ops


class RasterParams(NamedTuple):
    """Per-sample raster parameters: host values (identity_params, pack)
    or device tensors (unpack_params)."""
    T_ref_world: torch.Tensor   # (4,4) world -> BEV reference frame
    bev_coords: torch.Tensor    # (3,) BEV origin in the reference frame
    window_min: torch.Tensor    # first in-horizon global frame id
    window_max: torch.Tensor    # last global frame id (inclusive)
    present_frame: torch.Tensor  # frames < this are 'present'
    rot_ang: torch.Tensor
    trans_dx: torch.Tensor
    trans_dy: torch.Tensor
    zoom: torch.Tensor          # aug_view = zoom * view_size
    warp_a1: torch.Tensor       # dense-warp column polynomial
    warp_a2: torch.Tensor
    warp_b1: torch.Tensor       # dense-warp row polynomial
    warp_b2: torch.Tensor
    height_thresh: torch.Tensor  # +inf = disabled

    def pack(self) -> np.ndarray:
        """Host values -> the (31,) float32 vector unpack_params reads."""
        return np.concatenate([
            np.asarray(self.T_ref_world, np.float32).reshape(-1),
            np.asarray(self.bev_coords, np.float32),
            np.array([self.window_min, self.window_max, self.present_frame,
                      self.rot_ang, self.trans_dx, self.trans_dy, self.zoom,
                      self.warp_a1, self.warp_a2, self.warp_b1, self.warp_b2,
                      self.height_thresh], np.float32)])


def unpack_params(vec) -> RasterParams:
    """View of a packed (31,) float32 parameter vector: pose_vec (22) ||
    aug9 (rot, dx, dy, zoom, a1, a2, b1, b2, height_thresh)."""
    s = vec[19:]
    return RasterParams(
        T_ref_world=vec[:16].reshape(4, 4), bev_coords=vec[16:19],
        window_min=s[0].to(torch.int32), window_max=s[1].to(torch.int32),
        present_frame=s[2].to(torch.int32), rot_ang=s[3], trans_dx=s[4],
        trans_dy=s[5], zoom=s[6], warp_a1=s[7], warp_a2=s[8],
        warp_b1=s[9], warp_b2=s[10], height_thresh=s[11])


def identity_params(T_ref_world=None, bev_coords=None, window=(0, 0),
                    present_frame=0, height_thresh=np.inf) -> RasterParams:
    """Host-side parameters with no augmentation and no warp."""
    T = np.eye(4, dtype=np.float32) if T_ref_world is None else T_ref_world
    c = np.zeros(3, np.float32) if bev_coords is None else bev_coords
    if height_thresh is None:
        height_thresh = np.inf
    return RasterParams(
        T_ref_world=np.asarray(T, np.float32),
        bev_coords=np.asarray(c, np.float32),
        window_min=int(window[0]), window_max=int(window[1]),
        present_frame=int(present_frame),
        rot_ang=0.0, trans_dx=0.0, trans_dy=0.0, zoom=1.0,
        warp_a1=1.0, warp_a2=0.0, warp_b1=1.0, warp_b2=0.0,
        height_thresh=float(height_thresh))


# Channel order inside the map stack, per split.
_SPLIT_CHANNELS = ('road', 'intensity', 'rgb_r', 'rgb_g', 'rgb_b', 'dynamic',
                   'elevation')


def _view_cells(ref_xyz, valid, pt_frame_ids, params, view_size, P):
    """Per-sample view of BEV-reference points: the augmented points t,
    the mask of valid in-window, in-view rows below the height threshold,
    their (clamped) int32 cell ids, and the 'present' split mask."""
    t = geo.geometric_transform(ref_xyz, params.rot_ang, params.trans_dx,
                                params.trans_dy)
    aug_view = params.zoom * view_size
    in_window = ((pt_frame_ids >= params.window_min)
                 & (pt_frame_ids <= params.window_max))
    m = valid & in_window & geo.crop_view_mask(t, aug_view)
    m &= t[:, 2] < params.height_thresh
    grid = geo.pos2grid(t[:, :2], aug_view, P)
    cells = geo.grid_cell_index(grid[:, 0], grid[:, 1], P)
    cells = cells.clamp(0, P * P - 1).to(torch.int32)
    return t, m, cells, pt_frame_ids < params.present_frame


def packed_params(params):
    """The (31,) parameter tensor of a packed tensor, or of a (pose_vec
    (22,), aug9 (9,)) pair."""
    if isinstance(params, tuple):
        pose_vec, aug9 = params
        return torch.cat([pose_vec, torch.as_tensor(
            aug9, dtype=torch.float32, device=pose_vec.device)])
    return params


def sample_view(points, valid, pt_frame_ids, inst_dyn, params, view_size,
                P):
    """Per-sample view of world-frame points under unpacked ``params``:
    the augmented points t, the (clamped) int32 cell ids, the static
    mask (valid, in window, in view, below the height threshold, neither
    the point nor its instance dynamic) and the 'present' split mask."""
    ref = (geo.homo_transform(params.T_ref_world, points[:, :3])
           - params.bev_coords)
    t, m, cells, present_m = _view_cells(ref, valid, pt_frame_ids, params,
                                         view_size, P)
    inst = points[:, cfg.PT_INST].clamp(0, inst_dyn.shape[0] - 1).to(
        torch.int64)
    dyn_eff = torch.maximum(points[:, cfg.PT_DYN], inst_dyn[inst])
    return t, cells, m & (dyn_eff != 1.0), present_m


def make_raster_fn(view_size, pixel_size, sem_idxs, int_scaler,
                   int_sep_scaler, int_mid_threshold, rgb_fill=0,
                   backend='sort', use_kernel=None, pack=None,
                   hist_medians=True):
    """Classic per-sample raster with the static BEV configuration baked
    in. fn(points (N,10), valid, pt_frame_ids, inst_dyn, params,
    gen_future) -> (S*7, P, P) float16 stack (S = 3 with gen_future, else
    1), warped; ``params`` is the packed (31,) parameter tensor or a
    (pose_vec (22,), aug9 (9,)) pair.

    ``backend``: 'sort' (ops/sort_raster.sorted_split_stats) or 'scatter'
    (the ops/rasterize spec). ``use_kernel`` (None means True) takes the
    sort backend's kernel route (the stats kernels on CUDA tensors, their
    plain versions on CPU ones); False its pure-torch route.
    ``hist_medians``: rgb medians from the kernel, else from sorts.
    """
    if pack is not None:
        raise NotImplementedError(
            f'pack={pack!r}: the port has the dense float16 output only '
            '(the sparse fetch is ROADMAP queue 1 item 4)')
    if backend not in ('sort', 'scatter'):
        raise ValueError(f"backend must be 'sort' or 'scatter', got "
                         f'{backend!r}')
    P = pixel_size
    sem_idxs = dict(sem_idxs)
    use_kernel = True if use_kernel is None else bool(use_kernel)

    def raster(points, valid, pt_frame_ids, inst_dyn, params, gen_future):
        params = unpack_params(packed_params(params))
        t, cells, static_m, present_m = sample_view(
            points, valid, pt_frame_ids, inst_dyn, params, view_size, P)
        z = t[:, 2]
        inten = points[:, cfg.PT_I]
        rgb = points[:, cfg.PT_R:cfg.PT_B + 1]
        sem = points[:, cfg.PT_SEM]
        meta = ['present', 'future', 'full'] if gen_future else ['present']
        if backend == 'sort':
            base_m = static_m if gen_future else (static_m & present_m)
            chs = sort_raster.sorted_split_stats(
                cells, base_m, ~present_m, z, inten, rgb, sem, sem_idxs, P,
                gen_future, rgb_fill=rgb_fill, use_kernel=use_kernel,
                hist_medians=hist_medians)
        else:
            splits = {'present': static_m & present_m}
            if gen_future:
                splits['future'] = static_m & ~present_m
                splits['full'] = static_m
            chs = {}
            for name, split_mask in splits.items():
                ch = ras.bev_split_channels(cells, split_mask, z, inten, rgb,
                                            sem, sem_idxs, P,
                                            rgb_fill=rgb_fill)
                for key, v in ch.items():
                    chs[f'{key}_{name}'] = v
        return emit_outputs(chs, meta, params, P, int_scaler,
                            int_sep_scaler, int_mid_threshold)

    return raster


def make_prep_fn(sem_idxs):
    """Once-per-step point prep. fn(points (N,10), inst_dyn, pose_vec (22,))
    -> (ref_xyz (N,3) f32, packed (N,) i32, packed2 (N,) i32); packed
    carries the effective dyn partition in bit 26."""
    road_ids = [sem_idxs['road']]
    dyn_ids = [sem_idxs[nm] for nm in cfg.DYN_OBJ_CLASSES]

    def prep(points, inst_dyn, pose_vec):
        T_ref_world = pose_vec[:16].reshape(4, 4)
        ref = geo.homo_transform(T_ref_world, points[:, :3]) - pose_vec[16:19]
        sem = points[:, cfg.PT_SEM]
        road_f = ras.sem_class_mask(sem, road_ids).to(torch.float32)
        dyn_f = ras.sem_class_mask(sem, dyn_ids).to(torch.float32)
        int_road = points[:, cfg.PT_I] * road_f
        rgb = points[:, cfg.PT_R:cfg.PT_B + 1]
        packed, packed2 = sort_raster.pack_payload_words(
            road_f, dyn_f, rgb, int_road, ref[:, 2])
        inst = points[:, cfg.PT_INST].clamp(0, inst_dyn.shape[0] - 1).to(
            torch.int64)
        dyn_eff = torch.maximum(points[:, cfg.PT_DYN], inst_dyn[inst])
        packed = packed | ((dyn_eff == 1.0).to(torch.int32) << 26)
        return ref, packed, packed2

    return prep


def make_prepped_raster_fn(view_size, pixel_size, int_scaler,
                           int_sep_scaler, int_mid_threshold, rgb_fill=0):
    """Per-sample raster over make_prep_fn outputs. fn(ref_xyz, valid,
    pt_frame_ids, packed, packed2, (pose_vec (22,), aug9 (9,)),
    gen_future) -> (S*7, P, P) float16 stack (S = 3 with gen_future, else
    1), warped."""
    P = pixel_size

    def raster(ref_xyz, valid, pt_frame_ids, packed, packed2, pv_aug,
               gen_future):
        params = unpack_params(torch.cat(pv_aug))
        _, m, cells, present_m = _view_cells(ref_xyz, valid, pt_frame_ids,
                                             params, view_size, P)
        static_m = m & (((packed >> 26) & 1) == 0)
        nsplit = 2 if gen_future else 1
        if gen_future:
            base_m = static_m
            key = cells * nsplit + (~present_m).to(torch.int32)
        else:
            base_m = static_m & present_m
            key = cells
        c2 = torch.where(base_m, key, P * P * nsplit).to(torch.int32)
        chs = sort_raster.split_stats_from_packed(
            c2, packed, packed2, P, gen_future, rgb_fill=rgb_fill)
        meta = ['present', 'future', 'full'] if gen_future else ['present']
        return emit_outputs(chs, meta, params, P, int_scaler,
                            int_sep_scaler, int_mid_threshold)

    return raster


def emit_outputs(chs, meta, params, P, int_scaler, int_sep_scaler,
                 int_mid_threshold):
    """Channel dict -> warped, finalized (S*7, P, P) float16 stack."""
    stack = []
    for name in meta:
        rgb = chs[f'rgb_{name}']
        stack += [chs[f'road_{name}'], chs[f'intensity_{name}'], rgb[0],
                  rgb[1], rgb[2], chs[f'dynamic_{name}'],
                  chs[f'elevation_{name}']]
    maps = torch.stack([m.reshape(P, P) for m in stack])
    maps = warp_ops.warp_dense_maps(maps, params.warp_a1, params.warp_a2,
                                    params.warp_b1, params.warp_b2)
    return finalize_dense(maps, len(meta), int_scaler, int_sep_scaler,
                          int_mid_threshold)


def finalize_dense(maps, n_splits, int_scaler, int_sep_scaler,
                   int_mid_threshold):
    """Road-marking transform on each split's intensity channel, then the
    whole stack as one float16 tensor."""
    n_ch = len(_SPLIT_CHANNELS)
    final = []
    for si in range(n_splits):
        base = si * n_ch
        final += [maps[base + 0],
                  ras.road_marking_transform(maps[base + 1], int_scaler,
                                             int_sep_scaler,
                                             int_mid_threshold),
                  *maps[base + 2:base + n_ch]]
    return torch.stack(final).to(torch.float16)


def unpack_maps(stack: np.ndarray, gen_future):
    """(C,P,P) float16 stack -> {road,intensity,rgb,dynamic,elevation}_split
    dict (rgb (3,P,P))."""
    meta = ('present', 'future', 'full') if gen_future else ('present',)
    n_ch = len(_SPLIT_CHANNELS)
    out = {}
    for si, name in enumerate(meta):
        base = si * n_ch
        out[f'road_{name}'] = stack[base + 0]
        out[f'intensity_{name}'] = stack[base + 1]
        out[f'rgb_{name}'] = stack[base + 2:base + 5]
        out[f'dynamic_{name}'] = stack[base + 5]
        out[f'elevation_{name}'] = stack[base + 6]
    return out
