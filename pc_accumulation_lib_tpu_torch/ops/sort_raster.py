"""Sort-based BEV channel statistics (the raster's stats stage).

Counterpart of ops/sort_raster.py. Rows are grouped by their key c2 =
cell*nsplit + is_future (sentinel for masked rows). Three routes give the
same maps:

  * the kernel route (default): one torch.sort on c2, the two packed
    payload words follow by a gather, and ops/segmented_stats computes
    every per-group sum, the z-min and (with hist_medians) the exact rgb
    medians in one pass over the sorted rows, either from the words
    (segmented_stats_words) or from rows unpacked here
    (segmented_stats, words_kernel=False);
  * without hist_medians the rgb medians come from sorts of
    (c2*256 + value) instead;
  * the pure-torch route (use_kernel=False): a 2-key sort by (c2, z),
    segment sums and boundary reads.

The 'full' split is present (+/min) future. On the kernel route with
hist_medians, ``compact_groups`` renumbers the groups by occupied-cell
rank (maps come back rank-indexed with a ``cell_of_rank`` table, for the
sparse pack of bev/core).
"""
from __future__ import annotations

import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.ops import rasterize as ras
from pc_accumulation_lib_tpu_torch.ops import segmented_stats


def _boundaries(sorted_c2, num_groups):
    """ends[g] = #rows with key <= g; starts[g] = ends[g-1]."""
    q = torch.arange(1, num_groups + 1, dtype=sorted_c2.dtype,
                     device=sorted_c2.device)
    ends = torch.searchsorted(sorted_c2, q, right=False,
                              out_int32=True)
    starts = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=ends.device), ends[:-1]])
    return starts, ends


def _median_from_sorted(packed_sorted, starts, lens, fill_value):
    """np.median of each group's u8 values from a sorted array of
    (group * 256 + value); group segment at [starts, starts+lens). Empty
    groups get fill_value."""
    n = packed_sorted.shape[0]
    p1 = (starts + torch.div(lens - 1, 2, rounding_mode='floor')).clamp(
        0, n - 1).to(torch.int64)
    p2 = (starts + lens // 2).clamp(0, n - 1).to(torch.int64)
    v1 = (packed_sorted[p1] % 256).to(torch.float32)
    v2 = (packed_sorted[p2] % 256).to(torch.float32)
    return torch.where(lens > 0, 0.5 * (v1 + v2),
                       torch.tensor(float(fill_value), dtype=torch.float32,
                                    device=v1.device))


def pack_payload_words(road_f, dyn_f, rgb, int_road, z):
    """Pack the per-point raster payloads into two int32 words:

      word1: road/dyn flags (bits 25/24) + the clipped u8 rgb in bits
        23..0 (bit-exact);
      word2: z as float16 bits (high half) + road-intensity as u16 (low
        half). Rounding z to f16 before the min commutes with the min, and
        the elevation channel ships as float16, so the output stays exact.
    """
    packed = ((road_f.to(torch.int32) << 25)
              | (dyn_f.to(torch.int32) << 24))
    for ch, shift in enumerate((16, 8, 0)):
        packed = packed | (rgb[:, ch].clamp(0., 255.).to(torch.int32)
                           << shift)
    z16 = z.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    i16 = torch.round(int_road.clamp(0., 1.) * 65535.0).to(torch.int32)
    return packed, (z16 << 16) | i16


def _medians_from_kernel(meds, lens, n_cells, nsplit, rgb_fill):
    """Split dict of the kernel's medians. meds: (3, 2, n_cells*nsplit)
    — [:, 0] per group, [:, 1] group pairs at even positions ('full').
    Empty groups take rgb_fill."""
    fill = float(rgb_fill)
    out = {}
    if nsplit == 2:
        lens2 = lens.view(n_cells, 2)
        pg = meds[:, 0, :].reshape(3, n_cells, 2)
        full = meds[:, 1, :].reshape(3, n_cells, 2)[:, :, 0]
        len_full = lens2.sum(-1)
        out['present'] = [torch.where(lens2[:, 0] > 0, pg[c, :, 0], fill)
                          for c in range(3)]
        out['future'] = [torch.where(lens2[:, 1] > 0, pg[c, :, 1], fill)
                         for c in range(3)]
        out['full'] = [torch.where(len_full > 0, full[c], fill)
                       for c in range(3)]
    else:
        out['present'] = [torch.where(lens > 0, meds[c, 0, :], fill)
                          for c in range(3)]
    return out


def _per_split_with_full(vecs, n_cells, gen_future):
    """Map each (sent,) vector to {present[, future, full]}; 'full' is
    present + future for counts/sums and the min for elevation."""
    reds = (torch.add, torch.add, torch.add, torch.add, torch.minimum)
    out = []
    for vec, red in zip(vecs, reds):
        if not gen_future:
            out.append({'present': vec})
            continue
        m = vec.view(n_cells, 2)
        d = {'present': m[:, 0], 'future': m[:, 1]}
        d['full'] = red(d['present'], d['future'])
        out.append(d)
    return tuple(out)


def _emit_split(out, s, cnt, road_c, int_s, dyn_c, zmin, meds):
    """Finalize one split's flat (n_cells,) channel maps: Dirichlet
    probmaps, road-mean intensity, min-z elevation, median rgb and the raw
    point counts."""
    out[f'road_{s}'] = (road_c + 1.0) / (cnt + 2.0)
    out[f'intensity_{s}'] = int_s / (road_c + 1.0)
    out[f'rgb_{s}'] = torch.stack(meds) / 255.0
    out[f'dynamic_{s}'] = (dyn_c + 1.0) / (cnt + 2.0)
    out[f'elevation_{s}'] = torch.where(cnt > 0, zmin, 0.0)
    out[f'count_{s}'] = cnt


def _median_sorts(c2, packed, starts, ends, n_cells, nsplit, gen_future,
                  rgb_fill, splits):
    """Exact per-split rgb medians from sorts of (c2*256 + value), the
    rgb bytes of word1; the boundary table ``starts``/``ends`` is per
    group."""
    sent = n_cells * nsplit
    med = {s: [] for s in splits}
    starts2 = starts.view(n_cells, nsplit)
    ends2 = ends.view(n_cells, nsplit)
    keyed = c2 < sent
    c2l = c2.to(torch.int64)
    for shift in (16, 8, 0):
        val = ((packed >> shift) & 255).to(torch.int64)
        pf_sorted = torch.sort(torch.where(keyed, c2l * 256 + val,
                                           sent * 256)).values
        med['present'].append(_median_from_sorted(
            pf_sorted, starts2[:, 0], ends2[:, 0] - starts2[:, 0],
            rgb_fill))
        if gen_future:
            med['future'].append(_median_from_sorted(
                pf_sorted, starts2[:, 1], ends2[:, 1] - starts2[:, 1],
                rgb_fill))
            full_sorted = torch.sort(torch.where(
                keyed, torch.div(c2l, nsplit, rounding_mode='floor') * 256
                + val, n_cells * 256)).values
            med['full'].append(_median_from_sorted(
                full_sorted, starts2[:, 0], ends2[:, 1] - starts2[:, 0],
                rgb_fill))
    return med


def _unpack_words(packed, packed2):
    """Rows of the payload words: (z (f16 -> f32), road-intensity,
    road flag, dyn flag), float32."""
    z = segmented_stats._decode_z(packed2)
    int_road = (packed2 & 0xFFFF).to(torch.float32) * (1.0 / 65535.0)
    road_f = ((packed >> 25) & 1).to(torch.float32)
    dyn_f = ((packed >> 24) & 1).to(torch.float32)
    return z, int_road, road_f, dyn_f


def _sort_by_key_then_z(c2, z, *payloads):
    """2-key sort by (c2, z): a stable sort by z, then a stable sort by
    c2. Returns the sorted c2, z and payloads."""
    o1 = torch.sort(z, stable=True).indices
    o2 = torch.sort(c2[o1], stable=True).indices
    order = o1[o2]
    return [t[order] for t in (c2, z, *payloads)]


def _sum_by_key(vals, s_c2, sent):
    """Per-group float32 sums (segment_sum over the sorted keys; the
    sentinel slot is dropped)."""
    out = torch.zeros((sent + 1,), dtype=torch.float32, device=vals.device)
    out.index_add_(0, s_c2.to(torch.int64), vals)
    return out[:sent]


def _pure_route(c2, packed, z, int_road, road_f, dyn_f, n_cells,
                gen_future, rgb_fill):
    """The pure-torch route: a 2-key sort by (c2, z) of the float
    features, group bounds, segment sums, the z at each group's start as
    its min, and the rgb medians from sorts of the words' rgb bytes."""
    nsplit = 2 if gen_future else 1
    sent = n_cells * nsplit
    s_c2, s_z, s_int, s_road, s_dyn = _sort_by_key_then_z(
        c2, z, int_road, road_f, dyn_f)
    starts, ends = _boundaries(s_c2, sent)
    lens = (ends - starts).to(torch.float32)
    zmin = s_z[starts.clamp(0, max(s_c2.shape[0] - 1, 0)).to(torch.int64)]
    vecs = (lens, _sum_by_key(s_road, s_c2, sent),
            _sum_by_key(s_dyn, s_c2, sent), _sum_by_key(s_int, s_c2, sent),
            torch.where(lens > 0, zmin, float('inf')))
    splits = _per_split_with_full(vecs, n_cells, gen_future)
    med = _median_sorts(c2, packed, starts, ends, n_cells, nsplit,
                        gen_future, rgb_fill, splits[0])
    return _emit_all(splits, med)


def _rank_keys(s_c2, nsplit, sent):
    """Rank-compacted keys of ascending keys ``s_c2``: each occupied
    cell's rank among the occupied cells (head flags, then a cumsum;
    rank order is ascending cell order) as rank*nsplit + is_future, and
    the sentinel ``sent`` (>= the kernel's group count) for masked
    rows."""
    cell_s = torch.div(s_c2, nsplit, rounding_mode='floor')
    head = torch.ones_like(cell_s)
    head[1:] = (cell_s[1:] != cell_s[:-1]).to(cell_s.dtype)
    rank = torch.cumsum(head, 0, dtype=torch.int32) - 1
    return torch.where(s_c2 < sent, rank * nsplit + s_c2 % nsplit,
                       sent).to(torch.int32)


def _cell_of_rank(s_c2, lens, n_cells, nsplit):
    """(n_cells,) int32 cell id of each rank, from the rank groups'
    lengths: the sorted key at each rank's first row; n_cells for the
    ranks past the last occupied cell."""
    grp = lens.to(torch.int64).view(n_cells, nsplit).sum(-1)
    if s_c2.numel() == 0:
        return torch.full((n_cells,), n_cells, dtype=torch.int32,
                          device=s_c2.device)
    starts = (torch.cumsum(grp, 0) - grp).clamp(max=s_c2.numel() - 1)
    cell = torch.div(s_c2[starts], nsplit, rounding_mode='floor')
    return torch.where(grp > 0, cell, n_cells).to(torch.int32)


def split_stats_from_words_flat(c2, packed, packed2, n_cells, gen_future,
                                rgb_fill=0, use_kernel=True,
                                hist_medians=True, words_kernel=True,
                                compact_groups=False):
    """Split stats from the packed payload words over a flat cell range.

    c2: (N,) int32 keys cell*nsplit + is_future, or the sentinel
    n_cells*nsplit for masked rows; packed/packed2: (N,) int32 words.
    ``use_kernel``: the 1-key sort + segmented-stats route (the kernel on
    CUDA tensors, its plain version on CPU ones); ``words_kernel`` feeds it
    the sorted words (segmented_stats_words), False unpacks them here and
    calls segmented_stats; ``hist_medians`` takes the rgb medians from the
    kernel, False from (c2*256 + value) sorts. ``use_kernel=False`` is the
    pure-torch route (2-key sort by (c2, z)). Every statistic is
    order-free, so the sorts need not be stable. Returns
    {channel_split: (n_cells,)} maps ((3, n_cells) for rgb).

    ``compact_groups`` (kernel route with hist_medians; ValueError
    otherwise): the kernel's groups are the occupied cells' ranks
    (rank*nsplit + is_future) instead of the cell space, so every keyed
    row lands in the first groups and the empty tail costs nothing. The
    maps come back rank-indexed, with an extra ``cell_of_rank`` (n_cells,)
    int32 (n_cells for the dead ranks past the last occupied cell)."""
    if compact_groups and not (use_kernel and hist_medians):
        raise ValueError('compact_groups needs the kernel route with '
                         'hist_medians (the median sorts read cell-space '
                         'keys)')
    nsplit = 2 if gen_future else 1
    sent = n_cells * nsplit
    if not use_kernel:
        return _pure_route(c2, packed, *_unpack_words(packed, packed2),
                           n_cells, gen_future, rgb_fill)

    s_c2, order = torch.sort(c2)
    s_packed, s_p2 = packed[order], packed2[order]
    g = _rank_keys(s_c2, nsplit, sent) if compact_groups else s_c2
    if words_kernel:
        st = segmented_stats.segmented_stats_words(
            g, s_packed, s_p2, sent, med_nsplit=nsplit,
            hist_medians=hist_medians)
    else:
        s_z, s_int, s_road, s_dyn = _unpack_words(s_packed, s_p2)
        value_rows = ([((s_packed >> shift) & 255).to(torch.float32)
                       for shift in (16, 8, 0)] if hist_medians else [])
        st = segmented_stats.segmented_stats(
            g, [torch.ones_like(s_road), s_road, s_dyn, s_int], s_z,
            sent, value_rows=value_rows, med_nsplit=nsplit)
    sums, zmin = st[0], st[1]
    lens = sums[:, 0]
    vecs = (lens, sums[:, 1], sums[:, 2], sums[:, 3],
            torch.where(lens > 0, zmin, float('inf')))
    splits = _per_split_with_full(vecs, n_cells, gen_future)
    if hist_medians:
        med = _medians_from_kernel(st[2], lens, n_cells, nsplit, rgb_fill)
    else:
        ends = torch.cumsum(lens.to(torch.int32), 0, dtype=torch.int32)
        starts = ends - lens.to(torch.int32)
        med = _median_sorts(c2, packed, starts, ends, n_cells, nsplit,
                            gen_future, rgb_fill, splits[0])
    out = _emit_all(splits, med)
    if compact_groups:
        out['cell_of_rank'] = _cell_of_rank(s_c2, lens, n_cells, nsplit)
    return out


def _emit_all(splits, med):
    lens_s, road_s, dyn_s, int_ss, zmin_s = splits
    out = {}
    for s in lens_s:
        _emit_split(out, s, lens_s[s], road_s[s], int_ss[s], dyn_s[s],
                    zmin_s[s], med[s])
    return out


def _to_maps(flat, P):
    return {k: v if k == 'cell_of_rank'
            else v.reshape((3, P, P) if v.dim() == 2 else (P, P))
            for k, v in flat.items()}


def split_stats_from_packed(c2, packed, packed2, pixel_size, gen_future,
                            rgb_fill=0, hist_medians=True,
                            compact_groups=False):
    """(P,P)-shaped kernel-route wrapper over split_stats_from_words_flat.
    With ``compact_groups`` the maps are rank-indexed (the (P,P) shape is
    a container) and the flat ``cell_of_rank`` rides along; only the
    sparse pack takes that form (bev/core.emit_outputs)."""
    return _to_maps(split_stats_from_words_flat(
        c2, packed, packed2, pixel_size * pixel_size, gen_future,
        rgb_fill=rgb_fill, hist_medians=hist_medians,
        compact_groups=compact_groups), pixel_size)


def sorted_split_stats(cells, static_m, is_future, z, intensity, rgb, sem,
                       sem_idxs, pixel_size, gen_future, rgb_fill=0,
                       use_kernel=False, hist_medians=False):
    """All channel families for all time splits via the sort formulation.

    Args:
      cells: (N,) int32 raster cell ids in [0, P*P).
      static_m: (N,) bool: valid & in-window & in-view & static.
      is_future: (N,) bool split membership (ignored without gen_future).
      z/intensity: (N,) float point features; rgb: (N,3) in [0,255].
      sem: (N,) semantic class ids.

    ``use_kernel`` packs the payload words and takes the kernel route
    (split_stats_from_packed); otherwise the pure-torch route sorts the
    float features by (c2, z). Returns {road, intensity (raw), rgb,
    dynamic, elevation, count} x {present[, future, full]} of (P,P) /
    (3,P,P) float32 maps, as the scatter spec (ops/rasterize) gives.
    """
    P = pixel_size
    n_cells = P * P
    nsplit = 2 if gen_future else 1
    sent = n_cells * nsplit
    isf = (is_future.to(torch.int32) if gen_future
           else torch.zeros_like(cells))
    c2 = torch.where(static_m, cells * nsplit + isf, sent).to(torch.int32)
    road_f = ras.sem_class_mask(sem, [sem_idxs['road']]).to(torch.float32)
    dyn_f = ras.sem_class_mask(
        sem, [sem_idxs[nm] for nm in cfg.DYN_OBJ_CLASSES]).to(torch.float32)
    int_road = intensity.to(torch.float32) * road_f
    packed, packed2 = pack_payload_words(road_f, dyn_f, rgb, int_road, z)
    if use_kernel:
        return split_stats_from_packed(c2, packed, packed2, P, gen_future,
                                       rgb_fill=rgb_fill,
                                       hist_medians=hist_medians)
    # The pure route sums the float features and reads the float32 z-min;
    # only the medians come from the (exact) rgb bytes of the words.
    return _to_maps(_pure_route(c2, packed, z.to(torch.float32), int_road,
                                road_f, dyn_f, n_cells, gen_future,
                                rgb_fill), P)
