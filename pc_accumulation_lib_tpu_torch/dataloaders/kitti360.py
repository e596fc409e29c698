"""KITTI-360 dataset IO: binary readers, calibration parsing, trainId remap,
and the observation dataloader.

The port's copy of the JAX package's dataloaders/kitti360.py
(counterparts of datasets/kitti360_utils.py:6-95 and
obs_dataloaders/kitti360_obs_dataloader.py:11-171). PIL is imported only
where an image is read, so the calibration readers need no PIL.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from pc_accumulation_lib_tpu_torch.dataloaders.base import (
    ObservationDataloader)


def read_pc_bin_file(path: str) -> np.ndarray:
    """float32 (N,4) [x,y,z,intensity] reader (kitti360_utils.py:6-12)."""
    return np.fromfile(path, dtype=np.float32).reshape((-1, 4))


def read_sem_gt_bin_file(path: str) -> Optional[np.ndarray]:
    """int16 (N,1) 3D semantic GT reader (kitti360_utils.py:15-24)."""
    if os.path.isfile(path):
        return np.expand_dims(np.fromfile(path, dtype=np.int16), axis=1)
    return None


# id -> trainId map (kitti360_obs_dataloader.py:115-171).
ID2TRAINID = {
    0: 2, 1: 255, 2: 255, 3: 255, 4: 2, 5: 2, 6: 9, 7: 0, 8: 1, 9: 9,
    10: 9, 11: 2, 12: 3, 13: 4, 14: 2, 15: 2, 16: 2, 17: 5, 18: 5, 19: 6,
    20: 7, 21: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15,
    29: 14, 30: 14, 31: 16, 32: 17, 33: 18, 34: 2, 35: 4, 36: 2, 37: 5,
    38: 5, 39: 2, 40: 2, 41: 2, 42: 2, 43: 13, 44: 2, -1: 13,
}


def conv_semantic_ids(sem_gt: np.ndarray, idx2idx: dict) -> np.ndarray:
    """Sequential in-place id remap (kitti360_utils.py:27-39).

    NOTE: reproduced sequentially on purpose — the reference applies the
    remaps one-by-one in dict order, so e.g. raw id 0 -> 2 (key 0) is then
    caught by key 2 -> 255. Output parity requires the same order-dependent
    behaviour.
    """
    for old_idx, new_idx in idx2idx.items():
        mask = sem_gt[:, 0] == old_idx
        sem_gt[mask] = new_idx
    return sem_gt


def get_transf_matrices(kitti360_path: str):
    """Parse calibration/calib_cam_to_velo.txt -> (H_cam_velo, H_velo_cam)
    homogeneous 4x4 matrices (kitti360_utils.py:57-74)."""
    calib_file = os.path.join(kitti360_path, 'calibration',
                              'calib_cam_to_velo.txt')
    H = np.genfromtxt(calib_file, delimiter=' ').reshape((3, 4))
    H_cam_velo = np.concatenate([H, np.array([[0., 0., 0., 1.]])], axis=0)
    return H_cam_velo, np.linalg.inv(H_cam_velo)


def get_camera_intrinsics(kitti360_path: str) -> np.ndarray:
    """Parse calibration/perspective.txt P_rect_00 -> (3,4)
    (kitti360_utils.py:77-95)."""
    calib_file = os.path.join(kitti360_path, 'calibration', 'perspective.txt')
    with open(calib_file) as f:
        for line in f:
            parts = line.split(':')
            if parts[0] == 'P_rect_00':
                nums = [s for s in parts[1].split() if s]
                return np.array(nums, dtype=float).reshape((3, 4))
    raise Exception("Did not find 'P_rect_00' entry in calibration file.")


class Kitti360Dataloader(ObservationDataloader):
    """Observation stream: (PIL image, (N,4) pc, (N,1) trainId sem GT) per
    frame (kitti360_obs_dataloader.py:11-106)."""

    def __init__(self, root_path: str, batch_size: int, sequences: List[str],
                 start_idxs: List[int], end_idxs: List[int]):
        super().__init__(root_path, batch_size)
        self.pc_paths: List[str] = []
        self.img_paths: List[str] = []
        self.sem_gt_paths: List[str] = []
        for seq_idx, seq_str in enumerate(sequences):
            pc_dir = os.path.join('data_3d_raw', seq_str, 'velodyne_points',
                                  'data')
            img_dir = os.path.join('data_2d_raw', seq_str, 'image_00',
                                   'data_rect')
            sem_gt_dir = os.path.join('data_3d_semantics', 'raw', seq_str,
                                      'labels')
            for idx in range(start_idxs[seq_idx], end_idxs[seq_idx]):
                idx_str = f'{idx:010d}'
                self.pc_paths.append(os.path.join(pc_dir, idx_str + '.bin'))
                self.img_paths.append(os.path.join(img_dir,
                                                   idx_str + '.png'))
                self.sem_gt_paths.append(
                    os.path.join(sem_gt_dir, idx_str + '.bin'))

    def __len__(self) -> int:
        return len(self.pc_paths)

    def read_obs(self, idx: int):
        import PIL.Image as Image
        pc = read_pc_bin_file(os.path.join(self.root_path,
                                           self.pc_paths[idx]))
        img = Image.open(os.path.join(self.root_path, self.img_paths[idx]))
        sem_gt = read_sem_gt_bin_file(
            os.path.join(self.root_path, self.sem_gt_paths[idx]))
        if sem_gt is None:
            print(f'Missing GT sem: {self.sem_gt_paths[idx]}')
            sem_gt = np.zeros((pc.shape[0], 1))
        sem_gt = conv_semantic_ids(sem_gt, ID2TRAINID)
        return (img, pc, sem_gt)
