"""Scatter-based BEV rasterizer: the readable spec the sort routes are
tested against, plus the class masks and the road-marking transform.

Counterpart of ops/rasterize.py. Every channel family is a scatter over
flat raster cell ids: counts and sums with index_add_, the min-z
elevation with scatter_reduce('amin'), and the exact per-cell colour
medians from 256-bin histograms read at the order statistics (n-1)//2
and n//2. Masked-out points go to a sentinel cell P*P, which is dropped.
"""
from __future__ import annotations

import torch

from pc_accumulation_lib_tpu_torch.config import DYN_OBJ_CLASSES


def _masked_cells(cells, mask, num_cells):
    return torch.where(mask, cells, num_cells).to(torch.int64)


def count_map(cells, mask, pixel_size, weights=None):
    """Per-cell (weighted) point counts -> (P,P) raster."""
    num_cells = pixel_size * pixel_size
    seg = _masked_cells(cells, mask, num_cells)
    if weights is None:
        data = mask.to(torch.float32)
    else:
        data = torch.where(mask, weights, 0.0).to(torch.float32)
    out = torch.zeros((num_cells + 1,), dtype=torch.float32,
                      device=cells.device)
    out.index_add_(0, seg, data)
    return out[:num_cells].reshape(pixel_size, pixel_size)


def dirichlet_probmap(count_sem, count_not_sem):
    """Posterior expectation of a 2-class Dirichlet with uniform prior:
    (c_sem + 1) / (c_sem + c_not + 2)."""
    return (count_sem + 1.0) / (count_sem + count_not_sem + 2.0)


def sem_probmap(cells, mask, sem_onehot_mask, pixel_size):
    """Probabilistic map of a semantic class set against the rest."""
    c_sem = count_map(cells, mask & sem_onehot_mask, pixel_size)
    c_not = count_map(cells, mask & ~sem_onehot_mask, pixel_size)
    return dirichlet_probmap(c_sem, c_not)


def intensity_map(cells, mask, intensity, pixel_size):
    """Mean intensity with a +1 count regularizer: sum / (count + 1)."""
    s = count_map(cells, mask, pixel_size, weights=intensity)
    c = count_map(cells, mask, pixel_size)
    return s / (c + 1.0)


def elevation_min_raw(cells, mask, z, pixel_size):
    """Per-cell min z, +inf for empty cells."""
    num_cells = pixel_size * pixel_size
    seg = _masked_cells(cells, mask, num_cells)
    zz = torch.where(mask, z, float('inf')).to(torch.float32)
    mn = torch.full((num_cells + 1,), float('inf'), dtype=torch.float32,
                    device=cells.device)
    mn.scatter_reduce_(0, seg, zz, reduce='amin')
    return mn[:num_cells].reshape(pixel_size, pixel_size)


def elevation_map(cells, mask, z, pixel_size):
    """Per-cell min z; unobserved cells are 0."""
    observed = count_map(cells, mask, pixel_size) > 0
    return torch.where(observed, elevation_min_raw(cells, mask, z,
                                                   pixel_size), 0.0)


def _hist_median(hist, counts, fill_value):
    """Exact median from per-cell integer-value histograms (C, B):
    0.5 * (v_{(n-1)//2} + v_{n//2}), both read off the cumulative
    histogram; empty cells get fill_value."""
    cum = torch.cumsum(hist, dim=-1)
    k1 = torch.div(counts - 1, 2, rounding_mode='floor')
    k2 = counts // 2
    v1 = torch.argmax((cum > k1[:, None]).to(torch.int8), dim=-1)
    v2 = torch.argmax((cum > k2[:, None]).to(torch.int8), dim=-1)
    med = 0.5 * (v1 + v2).to(torch.float32)
    return torch.where(counts > 0, med,
                       torch.tensor(float(fill_value), dtype=torch.float32,
                                    device=med.device))


def _value_histogram(cells, mask, values, num_cells, num_bins):
    vi = values.to(torch.int32).clamp(0, num_bins - 1).to(torch.int64)
    flat = _masked_cells(cells.to(torch.int64) * num_bins + vi, mask,
                         num_cells * num_bins)
    hist = torch.zeros((num_cells * num_bins + 1,), dtype=torch.int32,
                       device=cells.device)
    hist.index_add_(0, flat, mask.to(torch.int32))
    return hist[:-1].reshape(num_cells, num_bins)


def median_value_map(cells, mask, values, pixel_size, num_bins=256,
                     fill_value=0):
    """Per-cell exact median of integer-valued features -> (P,P)."""
    num_cells = pixel_size * pixel_size
    hist = _value_histogram(cells, mask, values, num_cells, num_bins)
    med = _hist_median(hist, hist.sum(dim=-1), fill_value)
    return med.reshape(pixel_size, pixel_size)


def rgb_median_maps(cells, mask, rgb, pixel_size, fill_value=0):
    """Per-cell median R/G/B maps; rgb (N,3) in [0,255]. Returns
    (3,P,P)."""
    return torch.stack([median_value_map(cells, mask, rgb[:, c], pixel_size,
                                         fill_value=fill_value)
                        for c in range(3)])


def rgb_histograms(cells, mask, rgb, pixel_size, num_bins=256):
    """(3, P*P, num_bins) int32 per-cell colour histograms."""
    num_cells = pixel_size * pixel_size
    return torch.stack([_value_histogram(cells, mask, rgb[:, c], num_cells,
                                         num_bins) for c in range(3)])


def split_accumulators(cells, mask, z, intensity, rgb, sem, sem_idxs,
                       pixel_size):
    """Per-split accumulators for one time split: sums everywhere except
    ``z_min``, which combines with min."""
    road_sel = sem_class_mask(sem, [sem_idxs['road']])
    dyn_sel = sem_class_mask(sem, [sem_idxs[name]
                                   for name in DYN_OBJ_CLASSES])
    return {
        'c_road': count_map(cells, mask & road_sel, pixel_size),
        'c_not_road': count_map(cells, mask & ~road_sel, pixel_size),
        'c_dynobj': count_map(cells, mask & dyn_sel, pixel_size),
        'c_not_dynobj': count_map(cells, mask & ~dyn_sel, pixel_size),
        'int_sum_road': count_map(cells, mask & road_sel, pixel_size,
                                  weights=intensity),
        'z_min': elevation_min_raw(cells, mask, z, pixel_size),
        'rgb_hist': rgb_histograms(cells, mask, rgb, pixel_size),
    }


def finalize_split(acc, pixel_size, rgb_fill=0):
    """Channel readout from the accumulators: Dirichlet expectation, mean
    intensity, elevation fill, histogram medians."""
    road = dirichlet_probmap(acc['c_road'], acc['c_not_road'])
    inten = acc['int_sum_road'] / (acc['c_road'] + 1.0)
    dyn = dirichlet_probmap(acc['c_dynobj'], acc['c_not_dynobj'])
    observed = (acc['c_road'] + acc['c_not_road']) > 0
    elev = torch.where(observed, acc['z_min'], 0.0)
    counts = acc['rgb_hist'].sum(dim=-1)
    rgbm = torch.stack([
        _hist_median(acc['rgb_hist'][c], counts[c], rgb_fill).reshape(
            pixel_size, pixel_size) for c in range(3)]) / 255.0
    return {'road': road, 'intensity': inten, 'rgb': rgbm, 'dynamic': dyn,
            'elevation': elev}


def road_marking_transform(intensity_raster, int_scaler, int_sep_scaler,
                           int_mid_threshold):
    """Sigmoid contrast stretch for road-marking intensity, clipped from
    above at 1."""
    out = int_scaler * torch.sigmoid(
        int_sep_scaler * (intensity_raster - int_mid_threshold))
    return torch.clamp(out, max=1.0)


def sem_class_mask(sem, class_idxs):
    """(N,) bool mask: sem in class_idxs."""
    mask = torch.zeros(sem.shape, dtype=torch.bool, device=sem.device)
    for c in class_idxs:
        mask |= sem == c
    return mask


def bev_split_channels(cells, mask, z, intensity, rgb, sem, sem_idxs,
                       pixel_size, rgb_fill=0):
    """All five channel families for one time split: road, intensity (raw,
    before the road-marking transform), rgb (3,P,P in [0,1]), dynamic and
    elevation."""
    acc = split_accumulators(cells, mask, z, intensity, rgb, sem, sem_idxs,
                             pixel_size)
    return finalize_split(acc, pixel_size, rgb_fill=rgb_fill)
