"""NuScenes GT lane centerlines (host numpy).

The port's copy of dataloaders/lanemap.py. Loading the lanes needs the
nuscenes-devkit's map expansion, imported only when they are loaded.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def crop_centerline_poses(pose_list: List[np.ndarray],
                          bbox: Tuple[float, float, float, float]):
    """Keep each polyline's points strictly inside the (x0, y0, x1, y1)
    box (global coordinates)."""
    out = []
    for poses in pose_list:
        poses = poses[(poses[:, 0] > bbox[0]) & (poses[:, 0] < bbox[2])]
        out.append(poses[(poses[:, 1] > bbox[1]) & (poses[:, 1] < bbox[3])])
    return out


def get_centerlines(dataroot: str, map_name: str,
                    bbox: Optional[tuple] = None,
                    resolution_meters: float = 1.) -> List[np.ndarray]:
    """Discretized lane centerlines in map coordinates."""
    from nuscenes.map_expansion.map_api import NuScenesMap
    nusc_map = NuScenesMap(dataroot=dataroot, map_name=map_name)
    poses = [np.asarray(p)
             for p in nusc_map.discretize_centerlines(resolution_meters)]
    if bbox is not None:
        poses = crop_centerline_poses(poses, bbox)
    return poses
