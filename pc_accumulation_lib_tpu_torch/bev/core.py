"""BEV raster on tensors.

Counterpart of bev/core.py. Two forms:

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
    augmented sample then runs the prepped raster
    (``make_prepped_raster_fn``), or a fetch group of them into one
    stacked buffer (``make_prepped_raster_group_fn``).

Outputs come in the JAX package's transfer encodings, byte for byte: the
dense float16 stack; ``pack='sparse'`` (an occupancy bitmask per split
and 8 bytes per occupied cell, shipped before the warp, with a
dense-words fallback for capacity overflow); and the quantized stack
(``quantize_stack``). Their host decoders are numpy (``decode_*``,
``dequantize_stack_batch``) and the native decoder of bev/native_decode.
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


def default_sparse_cap(pixel_size: int) -> int:
    """Default occupied-cell capacity of the sparse fetch: 60% of the
    raster, rounded up to a multiple of 128. Only the used prefix of a
    buffer is fetched, so a generous cap costs device memory, not link
    bytes, and keeps the dense fallback rare."""
    return ((pixel_size * pixel_size * 3 // 5) + 127) // 128 * 128


def make_raster_fn(view_size, pixel_size, sem_idxs, int_scaler,
                   int_sep_scaler, int_mid_threshold, rgb_fill=0,
                   backend='sort', use_kernel=None, pack=None,
                   sparse_cap=None, hist_medians=True):
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
    ``pack='sparse'`` (sort backend only): fn returns the pair of flat
    uint8 buffers (sparse, dense-words fallback) of ``sparse_outputs``,
    before the warp; ``sparse_cap`` is an int or the (present, future,
    full) caps (None: ``default_sparse_cap``).
    """
    if pack not in (None, 'sparse'):
        raise ValueError(f"pack must be None or 'sparse', got {pack!r}")
    if backend not in ('sort', 'scatter'):
        raise ValueError(f"backend must be 'sort' or 'scatter', got "
                         f'{backend!r}')
    if pack == 'sparse' and backend != 'sort':
        raise ValueError("pack='sparse' requires backend='sort'")
    P = pixel_size
    sem_idxs = dict(sem_idxs)
    use_kernel = True if use_kernel is None else bool(use_kernel)
    if sparse_cap is None:
        sparse_cap = default_sparse_cap(P)

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
                            int_sep_scaler, int_mid_threshold, pack=pack,
                            sparse_cap=sparse_cap)

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
                           int_sep_scaler, int_mid_threshold, rgb_fill=0,
                           pack=None, sparse_cap=None, compact_groups=False):
    """Per-sample raster over make_prep_fn outputs. fn(ref_xyz, valid,
    pt_frame_ids, packed, packed2, (pose_vec (22,), aug9 (9,)),
    gen_future, out=None) -> (S*7, P, P) float16 stack (S = 3 with
    gen_future, else 1), warped; with ``pack='sparse'`` the pair of
    make_raster_fn, written into ``out`` (a pair of flat uint8 views of
    the sizes ``sparse_buffer_bytes`` gives) when it is given.

    ``compact_groups`` (sparse only): the stats kernel runs over
    occupied-cell ranks instead of the cell space
    (ops/sort_raster.split_stats_from_words_flat); the sparse buffer's
    used bytes are the same and the fallback carries a cell_of_rank
    prefix."""
    P = pixel_size
    if pack not in (None, 'sparse'):
        raise ValueError(f"pack must be None or 'sparse', got {pack!r}")
    if compact_groups and pack != 'sparse':
        raise ValueError("compact_groups requires pack='sparse' (dense "
                         'outputs need cell-space maps)')
    if sparse_cap is None:
        sparse_cap = default_sparse_cap(P)

    def raster(ref_xyz, valid, pt_frame_ids, packed, packed2, pv_aug,
               gen_future, out=None):
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
            c2, packed, packed2, P, gen_future, rgb_fill=rgb_fill,
            compact_groups=compact_groups)
        meta = ['present', 'future', 'full'] if gen_future else ['present']
        return emit_outputs(chs, meta, params, P, int_scaler,
                            int_sep_scaler, int_mid_threshold, pack=pack,
                            sparse_cap=sparse_cap, out=out)

    return raster


def make_prepped_raster_group_fn(view_size, pixel_size, int_scaler,
                                 int_sep_scaler, int_mid_threshold,
                                 rgb_fill=0, pack=None, sparse_cap=None,
                                 compact_groups=False):
    """A fetch group of prepped rasters. fn(ref_xyz, valid, pt_frame_ids,
    packed, packed2, pose_vec (22,), aug9s (G, 9), gen_future) -> the G
    samples' outputs stacked on a leading axis: (G, S*7, P, P) float16,
    or with ``pack='sparse'`` the pair (G, sparse bytes) and (G, fallback
    bytes) uint8, each sample writing its row of one preallocated buffer,
    so a group leaves the card in one copy. Row i equals the per-sample
    raster of aug9s[i], bit for bit."""
    P = pixel_size
    if sparse_cap is None:
        sparse_cap = default_sparse_cap(P)
    body = make_prepped_raster_fn(view_size, P, int_scaler, int_sep_scaler,
                                  int_mid_threshold, rgb_fill, pack,
                                  sparse_cap, compact_groups)

    def raster_group(ref_xyz, valid, pt_frame_ids, packed, packed2,
                     pose_vec, aug9s, gen_future):
        args = (ref_xyz, valid, pt_frame_ids, packed, packed2)
        G = aug9s.shape[0]
        if pack != 'sparse':
            return torch.stack([body(*args, (pose_vec, aug9s[i]),
                                     gen_future) for i in range(G)])
        sp, dn = empty_sparse_group(G, P, gen_future, sparse_cap,
                                    compact_groups, ref_xyz.device)
        for i in range(G):
            body(*args, (pose_vec, aug9s[i]), gen_future, out=(sp[i], dn[i]))
        return sp, dn

    return raster_group


def emit_outputs(chs, meta, params, P, int_scaler, int_sep_scaler,
                 int_mid_threshold, pack=None, sparse_cap=None, out=None):
    """Channel dict -> the raster's output: the warped, finalized
    (S*7, P, P) float16 stack, or with ``pack='sparse'`` the
    ``sparse_outputs`` pair of the stack before the warp (the warp is a
    reindexing that commutes with every later elementwise op, and it
    would add occupied cells; the host applies it after the decode).

    When ``chs`` carries 'cell_of_rank' the maps are rank-indexed
    (ops/sort_raster compact_groups), which only the sparse pack takes:
    every op up to it is elementwise and it keys back to cell space."""
    cell_of_rank = chs.get('cell_of_rank')
    stack = []
    for name in meta:
        rgb = chs[f'rgb_{name}']
        stack += [chs[f'road_{name}'], chs[f'intensity_{name}'], rgb[0],
                  rgb[1], rgb[2], chs[f'dynamic_{name}'],
                  chs[f'elevation_{name}']]
    maps = torch.stack([m.reshape(P, P) for m in stack])
    if pack != 'sparse':
        if cell_of_rank is not None:
            raise ValueError('rank-indexed maps need pack=\'sparse\'')
        maps = warp_ops.warp_dense_maps(maps, params.warp_a1, params.warp_a2,
                                        params.warp_b1, params.warp_b2)
        return finalize_dense(maps, len(meta), int_scaler, int_sep_scaler,
                              int_mid_threshold)
    dense = finalize_dense(maps, len(meta), int_scaler, int_sep_scaler,
                           int_mid_threshold)
    counts = torch.stack([chs[f'count_{name}'].reshape(P, P)
                          for name in meta])
    return sparse_outputs(dense, counts, P, sparse_cap, len(meta),
                          cell_of_rank=cell_of_rank, out=out)


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


# ----------------------------------------------------------------------
# Transfer encodings (device side) and their host decoders (numpy)
# ----------------------------------------------------------------------

def resolve_sparse_caps(cap):
    """int-or-tuple sparse cap -> (present, future, full-delta) 3-tuple;
    slice [:n_splits] for the active split count. The full split ships
    as a delta at the cells occupied in both present and future, so its
    cap bounds that overlap. An int applies to all three."""
    if isinstance(cap, (tuple, list)):
        if len(cap) != 3:
            raise ValueError(f'need (present, future, full) caps, got {cap}')
        return tuple(int(c) for c in cap)
    return (int(cap),) * 3


def sparse_header_bytes(pixel_size: int, gen_future: bool) -> int:
    """Byte length of a sparse buffer's fixed header: the occupancy
    bitmask(s), then 16 bytes holding the per-split occupied counts."""
    n_masks = 2 if gen_future else 1
    return n_masks * pixel_size * pixel_size // 8 + 16


def sparse_buffer_bytes(pixel_size: int, gen_future: bool, sparse_cap,
                        compact_groups: bool = False):
    """(sparse buffer bytes, dense-words fallback bytes) of one raster:
    the header plus 8 bytes per cap row, and 8 bytes per cell and split
    (plus the 4-byte cell_of_rank table of a rank-compacted raster)."""
    S = 3 if gen_future else 1
    n_cells = pixel_size * pixel_size
    caps = resolve_sparse_caps(sparse_cap)[:S]
    return (sparse_header_bytes(pixel_size, gen_future) + 8 * sum(caps),
            S * n_cells * 8 + (4 * n_cells if compact_groups else 0))


def empty_sparse_group(G, pixel_size, gen_future, sparse_cap,
                       compact_groups, device):
    """The (G, sparse bytes) and (G, fallback bytes) uint8 buffers a
    fetch group of sparse rasters writes, one row per sample."""
    nb, nd = sparse_buffer_bytes(pixel_size, gen_future, sparse_cap,
                                 compact_groups)
    return (torch.empty((G, nb), dtype=torch.uint8, device=device),
            torch.empty((G, nd), dtype=torch.uint8, device=device))


def read_sparse_noccs(raw, pixel_size: int, gen_future: bool) -> np.ndarray:
    """Per-split occupied-cell counts from a sparse buffer's header
    (host side; works on a truncated fetch too)."""
    S = 3 if gen_future else 1
    h = sparse_header_bytes(pixel_size, gen_future) - 16
    return np.ascontiguousarray(raw[h:h + 4 * S]).view(np.int32)


def sparse_used_bytes(raw, pixel_size: int, gen_future: bool) -> int:
    """Bytes of a sparse buffer the decode reads: the header plus 8 bytes
    per occupied cell over the sections (the rest is cap padding)."""
    noccs = read_sparse_noccs(raw, pixel_size, gen_future)
    return (sparse_header_bytes(pixel_size, gen_future)
            + 8 * int(noccs.sum()))


def _pack_channel_words(dense, S, n_cells):
    """(S*7, P, P) float16 stack -> (S, n_cells, 2) int32 words, each
    cell's channels byte-packed little-endian as [road, intensity, r, g |
    b, dyn, elev_lo, elev_hi]: six [0,1] channels as round(x*255) and the
    float16 elevation's bits. A view of the (S, n_cells, 8) uint8 rows
    the sparse pack gathers and the fallback ships."""
    ch = dense.reshape(S, 7, n_cells)
    u8 = torch.round(ch[:, :6].to(torch.float32).clamp(0., 1.)
                     * 255.).to(torch.uint8)                   # (S, 6, n)
    elev = ch[:, 6].to(torch.float16).contiguous().view(torch.uint8)
    rows = torch.cat([u8.transpose(1, 2),
                      elev.view(S, n_cells, 2)], dim=2)        # (S, n, 8)
    return rows.contiguous().view(torch.int32)


def _occupied_first(occ):
    """Indices of the True entries of ``occ`` in ascending order, then of
    the False ones (a stable argsort of where(occ, index, n)), by two
    cumsums and a scatter: no sort, no host sync."""
    o = occ.to(torch.int64)
    n_occ = o.sum()
    pos = torch.where(occ, torch.cumsum(o, 0) - 1,
                      n_occ + torch.cumsum(1 - o, 0) - 1)
    return torch.empty_like(pos).scatter_(
        0, pos, torch.arange(occ.numel(), device=occ.device))


def _pack_sparse(words, counts, P, caps, S, cell_of_rank=None, out=None):
    """Device-side sparse pack: (S, P*P, 2) int32 words + (S, P, P)
    counts -> flat uint8 buffer, written into ``out`` when given.

    Layout, S == 1: [mask (P*P/8) | n_occ i32 + pad to 16 B | values
    (n_occ rows of 8 B in a (caps[0], 8) region)]. S == 3: [masks present
    + future | n_occ (3,) i32 + pad | present values | future values |
    full-delta values], the sections packed one after another by their
    occupied counts inside a (caps[0] + caps[1] + caps[2], 8) region:
    only header + used bytes need to leave the card. The full split is
    present (+) future, so it equals one of them wherever the other has
    no points and ships as a delta at the overlap cells only. Occupied
    cells go in ascending cell order; a section's rows past its count
    hold the next unoccupied cells' words, as the JAX package's stable
    argsort leaves them, and a section that would run past the region
    starts early, as dynamic_update_slice clamps it.

    ``cell_of_rank`` (rank-compacted raster): words and counts are
    rank-indexed. Rank order is ascending cell order, so the value rows
    are the same; only the bitmasks are keyed back to cell space."""
    n_cells = P * P
    dev = words.device
    rows = words.view(torch.uint8)                              # (S, n, 8)
    occs = [counts[s].reshape(-1) > 0 for s in range(min(S, 2))]
    if S == 3:
        occs.append(occs[0] & occs[1])   # full-delta: the overlap
    noccs = torch.stack([o.sum() for o in occs]).to(torch.int32)
    total = sum(caps[:S])
    region = torch.zeros((total, 8), dtype=torch.uint8, device=dev)
    for s in range(S):
        idx = _occupied_first(occs[s])[:caps[s]]
        vals = rows[s].index_select(0, idx)
        n = vals.shape[0]
        if s == 0:
            region[:n] = vals
            continue
        start = noccs[:s].sum().to(torch.int64).clamp(max=total - n)
        region.index_copy_(0, start + torch.arange(n, device=dev), vals)

    def cell_space(occ):
        if cell_of_rank is None:
            return occ
        m = torch.zeros((n_cells + 1,), dtype=torch.bool, device=dev)
        m[cell_of_rank.clamp(0, n_cells).to(torch.int64)] = occ
        return m[:n_cells]

    # Bit j of a mask byte (MSB first, as np.packbits) from a shift made
    # on the device: a host-built table would be a blocking copy per raster.
    shifts = torch.arange(7, -1, -1, device=dev).to(torch.uint8)
    masks = [(cell_space(occs[s]).view(-1, 8).to(torch.uint8) << shifts)
             .sum(1, dtype=torch.uint8) for s in range(min(S, 2))]
    parts = masks + [noccs.view(torch.uint8),
                     torch.zeros(16 - 4 * S, dtype=torch.uint8, device=dev),
                     region.view(-1)]
    return torch.cat(parts) if out is None else torch.cat(parts, out=out)


def sparse_outputs(dense, counts, P, sparse_cap, n_splits,
                   cell_of_rank=None, out=None):
    """(sparse_u8, dense_fallback_u8) transfer encodings of a finalized
    (S*7, P, P) float16 stack and its (S, P, P) counts; ``out`` is an
    optional pair of flat uint8 views to write them into. The fallback is
    the channel words' bytes, cell-interleaved (decode_dense_words);
    with ``cell_of_rank`` the inputs are rank-indexed and the fallback is
    prefixed by that int32 table, which the host decode scatters back."""
    caps = resolve_sparse_caps(sparse_cap)[:n_splits]
    words = _pack_channel_words(dense, n_splits, P * P)
    fb = [words.view(torch.uint8).reshape(-1)]
    if cell_of_rank is not None:
        fb.insert(0, cell_of_rank.to(torch.int32).view(torch.uint8))
    sp_out, fb_out = (None, None) if out is None else out
    fb = torch.cat(fb) if fb_out is None else torch.cat(fb, out=fb_out)
    return (_pack_sparse(words, counts, P, caps, n_splits,
                         cell_of_rank=cell_of_rank, out=sp_out), fb)


class SparseOverflow(Exception):
    """More occupied raster cells than the sparse capacity: the caller
    falls back to the dense-words buffer (nothing is lost)."""


class SparseShortFetch(Exception):
    """A truncated fetch shipped fewer bytes than this sample's occupied
    cells need: the caller fetches the whole buffer (nothing is lost)."""


def sparse_empty_values(int_scaler, int_sep_scaler, int_mid_threshold,
                        rgb_fill=0):
    """The constants every unoccupied cell holds, per u8 channel [road,
    intensity (after the road-marking transform), r, g, b, dynamic]."""
    int_empty = min(
        float(int_scaler)
        / (1.0 + np.exp(float(int_sep_scaler) * float(int_mid_threshold))),
        1.0)
    f = rgb_fill / 255.0
    return (0.5, int_empty, f, f, f, 0.5)


_N_U8_CH = 6   # road, intensity (transformed), r, g, b, dynamic: all [0,1]
_DEQUANT_LUT = (np.arange(256, dtype=np.float32) / 255.).astype(np.float16)


def decode_sparse_stack(raw, gen_future, pixel_size, cap, empty_vals):
    """Host inverse of _pack_sparse for one sample: flat uint8 -> (S*7, P,
    P) float16 stack (unpack_maps layout), before the warp. ``cap`` int or
    per-split tuple. Raises ValueError below the fixed header,
    SparseOverflow when a split exceeded its cap, SparseShortFetch when
    ``raw`` is truncated below the used bytes. The full split is the
    present copy, overwritten with the future section at future-only
    cells and with the delta section at the overlap cells."""
    S = 3 if gen_future else 1
    P = pixel_size
    caps = list(resolve_sparse_caps(cap)[:S])
    n_masks = 2 if S == 3 else S
    n_mask = P * P // 8
    hdr = sparse_header_bytes(P, gen_future)
    if raw.shape[0] < hdr:
        raise ValueError(f'malformed sparse buffer: {raw.shape[0]} B < '
                         f'{hdr} B fixed header')
    masks = raw[:n_masks * n_mask].reshape(n_masks, n_mask)
    n_occ = read_sparse_noccs(raw, P, gen_future)
    for s in range(S):
        if int(n_occ[s]) > caps[s]:
            raise SparseOverflow(
                f'split {s}: {int(n_occ[s])} occupied cells > sparse cap '
                f'{caps[s]}')
    vb = n_masks * n_mask + 16
    need = vb + 8 * int(n_occ.sum())
    if raw.shape[0] < need:
        raise SparseShortFetch(
            f'truncated fetch shipped {raw.shape[0]} B < {need} B used')
    offs = vb + 8 * np.concatenate([[0], np.cumsum(n_occ[:-1])])
    stack = np.empty((S, 7, P * P), np.float16)
    empty7 = np.asarray(list(empty_vals) + [0.0], np.float16)[:, None]
    bits = [np.unpackbits(masks[m]).astype(bool) for m in range(n_masks)]
    idxs = [np.flatnonzero(b) for b in bits]

    def decode_vals(s):
        n = int(n_occ[s])
        v = raw[offs[s]:offs[s] + 8 * n].reshape(n, 8)
        vals = np.empty((7, n), np.float16)
        vals[:6] = _DEQUANT_LUT[v[:, :6]].T
        vals[6] = np.ascontiguousarray(v[:, 6:8]).view(np.float16)[:, 0]
        return vals

    fut_vals = None
    for s in range(min(S, 2)):
        stack[s] = empty7
        vals = decode_vals(s)
        stack[s, :, idxs[s]] = vals.T
        if s == 1:
            fut_vals = vals
    if S == 3:
        stack[2] = stack[0]
        both = bits[0][idxs[1]]           # overlap, in future-cell order
        stack[2, :, idxs[1][~both]] = fut_vals[:, ~both].T
        stack[2, :, idxs[1][both]] = decode_vals(2).T
    return stack.reshape(S * 7, P, P)


def decode_dense_words(raw, gen_future, pixel_size):
    """Host decode of the sparse path's dense fallback (the uint8 view of
    _pack_channel_words) -> (S*7, P, P) float16 stack, before the warp.
    Two layouts, told apart by length: cell space (S*P*P*8 bytes), and a
    rank-compacted raster's (a 4*P*P-byte cell_of_rank int32 table, then
    S*P*P*8 rank-indexed bytes), scattered back to cell space here; its
    dead ranks hold the empty-cell row, which fills the cells no rank
    covers."""
    S = 3 if gen_future else 1
    P = pixel_size
    n_cells = P * P
    raw = np.ascontiguousarray(raw)
    if raw.shape[0] == 4 * n_cells + S * n_cells * 8:
        cor = raw[:4 * n_cells].view(np.int32)
        v = raw[4 * n_cells:].reshape(S, n_cells, 8)
        live = cor < n_cells
        full = np.empty_like(v)
        if not live.all():
            full[:] = v[:, ~live][:, :1]
        full[:, cor[live]] = v[:, live]
        v = full
    else:
        v = raw.reshape(S, n_cells, 8)
    ch = _DEQUANT_LUT[v[:, :, :6]]                       # (S, n, 6) f16
    elev = np.ascontiguousarray(v[:, :, 6:8]).view(np.float16)[..., 0]
    stack = np.concatenate([np.transpose(ch, (0, 2, 1)), elev[:, None]],
                           axis=1)
    return stack.reshape(S * 7, P, P)


def quantize_stack_batch(stacks):
    """(B, S*7, P, P) float16 rasters -> (B, bytes) uint8: per split the
    six [0,1] channels as round(x*255), then every elevation channel's
    float16 bytes. 1.75x fewer bytes than float16; inverse
    dequantize_stack_batch."""
    B, C, P, _ = stacks.shape
    S = C // len(_SPLIT_CHANNELS)
    x = stacks.reshape(B, S, len(_SPLIT_CHANNELS), P, P)
    u8 = torch.round(x[:, :, :_N_U8_CH].to(torch.float32).clamp(0., 1.)
                     * 255.).to(torch.uint8)
    elev = x[:, :, _N_U8_CH].to(torch.float16).contiguous().view(
        torch.uint8)
    return torch.cat([u8.reshape(B, -1), elev.reshape(B, -1)], dim=1)


def quantize_stack(stack):
    """One (S*7, P, P) float16 raster -> its flat uint8 buffer (a row of
    quantize_stack_batch)."""
    return quantize_stack_batch(stack[None])[0]


def dequantize_stack_batch(raw, gen_future, pixel_size):
    """Host inverse of quantize_stack_batch: (B, bytes) uint8 numpy ->
    (B, S*7, P, P) float16 (the u8 channels through a 256-entry float16
    table)."""
    B = raw.shape[0]
    S = 3 if gen_future else 1
    P = pixel_size
    n_u8 = S * _N_U8_CH * P * P
    ch = _DEQUANT_LUT[raw[:, :n_u8]].reshape(B, S, _N_U8_CH, P, P)
    elev = np.ascontiguousarray(
        raw[:, n_u8:]).reshape(B, S, P, P, 2).view(np.float16)[..., 0]
    stack = np.concatenate([ch, elev[:, :, None]], axis=2)
    return stack.reshape(B, S * len(_SPLIT_CHANNELS), P, P)


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
