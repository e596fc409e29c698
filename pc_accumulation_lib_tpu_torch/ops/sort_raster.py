"""Sort-based BEV channel statistics (the raster's stats stage).

Counterpart of ops/sort_raster.py, kernel branch only: the rows are sorted
by their group key c2 = cell*nsplit + is_future (sentinel for masked rows)
with one torch.sort, the two packed payload words follow by a gather, and
ops/segmented_stats computes every per-group sum, the z-min and the exact
rgb medians in one pass over the sorted rows. The 'full' split is present
(+/min) future.
"""
from __future__ import annotations

import torch

from pc_accumulation_lib_tpu_torch.ops import segmented_stats


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
    probmaps, road-mean intensity, min-z elevation, median rgb."""
    out[f'road_{s}'] = (road_c + 1.0) / (cnt + 2.0)
    out[f'intensity_{s}'] = int_s / (road_c + 1.0)
    out[f'rgb_{s}'] = torch.stack(meds) / 255.0
    out[f'dynamic_{s}'] = (dyn_c + 1.0) / (cnt + 2.0)
    out[f'elevation_{s}'] = torch.where(cnt > 0, zmin, 0.0)


def split_stats_from_words_flat(c2, packed, packed2, n_cells, gen_future,
                                rgb_fill=0):
    """Split stats from the packed payload words over a flat cell range.

    c2: (N,) int32 keys cell*nsplit + is_future, or the sentinel
    n_cells*nsplit for masked rows; packed/packed2: (N,) int32 words. The
    sort need not be stable: every statistic is order-free. Returns
    {channel_split: (n_cells,)} maps ((3, n_cells) for rgb)."""
    nsplit = 2 if gen_future else 1
    sent = n_cells * nsplit
    s_c2, order = torch.sort(c2)
    sums, zmin, kmeds = segmented_stats.segmented_stats_words(
        s_c2, packed[order], packed2[order], sent, med_nsplit=nsplit)
    lens = sums[:, 0]
    road_c, dyn_c, int_s = sums[:, 1], sums[:, 2], sums[:, 3]
    lens_s, road_s, dyn_s, int_ss, zmin_s = _per_split_with_full(
        (lens, road_c, dyn_c, int_s, zmin), n_cells, gen_future)
    med = _medians_from_kernel(kmeds, lens, n_cells, nsplit, rgb_fill)
    out = {}
    for s in lens_s:
        _emit_split(out, s, lens_s[s], road_s[s], int_ss[s], dyn_s[s],
                    zmin_s[s], med[s])
    return out


def split_stats_from_packed(c2, packed, packed2, pixel_size, gen_future,
                            rgb_fill=0):
    """(P,P)-shaped wrapper over split_stats_from_words_flat."""
    P = pixel_size
    flat = split_stats_from_words_flat(c2, packed, packed2, P * P,
                                       gen_future, rgb_fill=rgb_fill)
    return {k: v.reshape((3, P, P) if v.dim() == 2 else (P, P))
            for k, v in flat.items()}
