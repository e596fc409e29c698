"""Per-point class masks and the road-marking intensity transform.

Counterpart of the two helpers of ops/rasterize.py that the step() raster
uses (sem_class_mask, road_marking_transform).
"""
from __future__ import annotations

import torch


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
