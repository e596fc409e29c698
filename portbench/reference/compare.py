"""The numbers that decide ``correct``: each the program's (or the
control's) distance from the reference, held to a limit of its own
(limits/<cell>.json). Plain NumPy on host copies."""
from __future__ import annotations

import math

import numpy as np


def _maps(sample):
    return {k: v for k, v in sample.items()
            if isinstance(v, np.ndarray) and v.ndim >= 2}


def map_mismatch(prog_samples, ref_samples, tol: float):
    """(share of map cells that differ by more than tol * (1 + |ref|),
    samples that are missing or of another layout)."""
    bad = total = 0
    missing = max(0, len(ref_samples) - len(prog_samples))
    for p, r in zip(prog_samples, ref_samples):
        pm, rm = _maps(p), _maps(r)
        if set(pm) != set(rm) or any(pm[k].shape != rm[k].shape
                                     for k in rm):
            missing += 1
            continue
        for k in rm:
            a = pm[k].astype(np.float32)
            b = rm[k].astype(np.float32)
            both_nan = np.isnan(a) & np.isnan(b)
            far = ~(np.abs(a - b) <= tol * (1.0 + np.abs(b))) & ~both_nan
            bad += int(far.sum())
            total += b.size
    return (bad / total if total else 0.0), missing


def _traj_lists(sample):
    return {k: v for k, v in sample.items()
            if k.startswith('trajs') or k == 'gt_lanes'}


def traj_gap(prog_samples, ref_samples) -> float:
    """Largest coordinate gap (BEV pixels) between the program's and the
    reference's trajectories and lanes (inf if their counts differ)."""
    gap = 0.0
    for p, r in zip(prog_samples, ref_samples):
        pt, rt = _traj_lists(p), _traj_lists(r)
        if set(pt) != set(rt):
            return math.inf
        for k in rt:
            if len(pt[k]) != len(rt[k]):
                return math.inf
            for a, b in zip(pt[k], rt[k]):
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                if a.shape != b.shape:
                    return math.inf
                if a.size:
                    gap = max(gap, float(np.nanmax(np.abs(a - b))))
    return gap


def judge(values: dict, limits: dict):
    """[(name, value, limit)] in the limits' order, and whether every
    value is within its limit (NaN is not)."""
    rows = [(k, float(values[k]), float(limits[k]['limit']))
            for k in limits if not k.startswith('_')]
    ok = all(v <= lim for _, v, lim in rows)
    return rows, ok
