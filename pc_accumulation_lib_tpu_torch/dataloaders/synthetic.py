"""Synthetic KITTI-360- and NuScenes-format observation streams (host
numpy).

Counterpart of dataloaders/synthetic.py (make_calib, _world_points,
SyntheticKitti360Stream, SyntheticNuScenesStream). The same seed gives
byte-identical points, labels and pixels; camera images are numpy uint8
(H,W,3) arrays here.

World model: straight road along +x with high-intensity lane markings,
sidewalks, building walls, poles, parked cars and vegetation; the ego
drives +x at a constant step and points are emitted in the ego frame.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Raw KITTI-360 label ids.
RAW_ROAD, RAW_SIDEWALK, RAW_BUILDING, RAW_VEGETATION, RAW_CAR = 7, 8, 11, 21, 26
RAW_POLE = 17

IMG_H, IMG_W = 188, 704            # test default (quarter-res rect)
FULL_IMG_H, FULL_IMG_W = 376, 1408  # real KITTI-360 rect resolution
EGO_Z = 1.73  # lidar height above road


def make_calib(img_hw: Tuple[int, int] = (IMG_H, IMG_W)
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H_cam_velo, H_velo_cam, P_cam_frame): camera at the lidar origin
    looking along +x_velo; the focal length scales with the image width so
    the painted point set is resolution-independent."""
    h, w = img_hw
    H_cam_velo = np.array([
        [0., 0., 1., 0.27],
        [-1., 0., 0., 0.],
        [0., -1., 0., -0.08],
        [0., 0., 0., 1.],
    ])
    H_velo_cam = np.linalg.inv(H_cam_velo)
    f = 350.0 * w / 704.0
    P_cam_frame = np.array([
        [f, 0., w / 2, 0.],
        [0., f, h / 2, 0.],
        [0., 0., 1., 0.],
    ])
    return H_cam_velo, H_velo_cam, P_cam_frame


def _world_points(rng: np.random.Generator, n_road=6000, n_side=1500,
                  n_bld=2500, n_veg=800, n_car=600, length=400.0):
    """Static world point set: (N,3) xyz, (N,) intensity, (N,) raw sem id.
    The draw order fixes the stream for a seed; keep it."""
    pts, inten, sem = [], [], []
    # Road plane y in [-4,4], z=0, dashed centre line and edge markings.
    x = rng.uniform(0, length, n_road)
    y = rng.uniform(-4, 4, n_road)
    marking = (np.abs(y) < 0.15) | (np.abs(np.abs(y) - 3.8) < 0.1)
    i_road = np.where(marking & (np.floor(x / 2) % 2 == 0), 0.9, 0.1)
    pts.append(np.stack([x, y, np.zeros(n_road)], 1))
    inten.append(i_road)
    sem.append(np.full(n_road, RAW_ROAD))
    # Sidewalks.
    x = rng.uniform(0, length, n_side)
    y = rng.choice([-1, 1], n_side) * rng.uniform(4.0, 6.0, n_side)
    pts.append(np.stack([x, y, np.full(n_side, 0.12)], 1))
    inten.append(rng.uniform(0.2, 0.4, n_side))
    sem.append(np.full(n_side, RAW_SIDEWALK))
    # Building walls at |y| ~ 8.
    x = rng.uniform(0, length, n_bld)
    y = rng.choice([-1, 1], n_bld) * rng.uniform(7.5, 8.5, n_bld)
    z = rng.uniform(0, 8.0, n_bld)
    pts.append(np.stack([x, y, z], 1))
    inten.append(rng.uniform(0.3, 0.6, n_bld))
    sem.append(np.full(n_bld, RAW_BUILDING))
    # Vegetation clumps.
    x = rng.uniform(0, length, n_veg)
    y = rng.choice([-1, 1], n_veg) * rng.uniform(6.0, 7.0, n_veg)
    z = rng.uniform(0.5, 3.0, n_veg)
    pts.append(np.stack([x, y, z], 1))
    inten.append(rng.uniform(0.4, 0.8, n_veg))
    sem.append(np.full(n_veg, RAW_VEGETATION))
    # Poles every ~8 m (longitudinal structure so ICP observes x-motion).
    for px in np.arange(4.0, length, 8.0):
        n_p = 40
        x = px + rng.normal(0, 0.02, n_p)
        y = rng.choice([-1, 1]) * 5.0 + rng.normal(0, 0.02, n_p)
        z = rng.uniform(0, 4.0, n_p)
        pts.append(np.stack([x, np.full(n_p, 0.) + y, z], 1))
        inten.append(rng.uniform(0.4, 0.7, n_p))
        sem.append(np.full(n_p, RAW_POLE))
    # Parked cars every ~30 m.
    centers = np.arange(15, length, 30.0)
    per = max(n_car // max(len(centers), 1), 1)
    for cx in centers:
        x = cx + rng.uniform(-2, 2, per)
        y = -3.0 + rng.uniform(-0.8, 0.8, per)
        z = rng.uniform(0.2, 1.5, per)
        pts.append(np.stack([x, y, z], 1))
        inten.append(rng.uniform(0.5, 0.9, per))
        sem.append(np.full(per, RAW_CAR))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(inten).astype(np.float32),
            np.concatenate(sem).astype(np.int16))


class SyntheticKitti360Stream:
    """In-memory observation stream in the KITTI-360 obs format: (rgb
    (H,W,3) uint8, (N,4) pc, (N,1) raw sem ids)."""

    def __init__(self, n_frames: int = 30, step: float = 2.0,
                 lidar_range: float = 60.0, seed: int = 0,
                 points_per_frame: Optional[int] = None,
                 yaw_rate: float = 0.0,
                 img_hw: Tuple[int, int] = (IMG_H, IMG_W)):
        """``yaw_rate`` [rad/frame] > 0 drives a curved trajectory;
        ``img_hw`` is the camera resolution (pair with make_calib)."""
        self.img_hw = tuple(img_hw)
        self.n_frames = n_frames
        self.step = step
        self.lidar_range = lidar_range
        self.yaw_rate = yaw_rate
        rng = np.random.default_rng(seed)
        length = n_frames * step + 2 * lidar_range
        scale = 1.0
        if points_per_frame is not None:
            scale = points_per_frame / 4000.0
        self.world, self.world_int, self.world_sem = _world_points(
            rng, n_road=int(6000 * scale), n_side=int(1500 * scale),
            n_bld=int(2500 * scale), n_veg=int(800 * scale),
            n_car=int(600 * scale), length=length)

    def ego_yaw(self, idx: int) -> float:
        return self.yaw_rate * idx

    def ego_pose(self, idx: int) -> np.ndarray:
        """World-frame ego position at frame idx."""
        if self.yaw_rate == 0.0:
            return np.array([self.lidar_range + idx * self.step, 0.0,
                             EGO_Z])
        xy = np.zeros(2)
        for k in range(idx):
            yaw = self.ego_yaw(k)
            xy += self.step * np.array([np.cos(yaw), np.sin(yaw)])
        return np.array([self.lidar_range + xy[0], xy[1], EGO_Z])

    def frame(self, idx: int):
        """Observation (rgb, pc, sem_gt) for frame idx, points in the ego
        frame."""
        pose = self.ego_pose(idx)
        rel = self.world - pose[None, :]
        m = np.linalg.norm(rel[:, :2], axis=1) < self.lidar_range
        rel = rel[m]
        yaw = self.ego_yaw(idx)
        if yaw != 0.0:
            c, s = np.cos(-yaw), np.sin(-yaw)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            rel = rel @ rot.T
        pc = np.concatenate([rel, self.world_int[m][:, None]],
                            axis=1).astype(np.float32)
        sem_gt = self.world_sem[m][:, None].copy()
        return self.render_image(idx), pc, sem_gt

    def render_image(self, idx: int) -> np.ndarray:
        """Cheap deterministic camera image (sky/road gradient), uint8."""
        h, w = self.img_hw
        v = np.linspace(0, 255, h, dtype=np.uint8)[:, None]
        img = np.zeros((h, w, 3), np.uint8)
        img[..., 0] = v
        img[..., 1] = 128
        col = np.linspace(0, 255, w).astype(np.int64)[None, :]
        img[..., 2] = ((col + idx) % 256).astype(np.uint8)
        return img

    def __len__(self):
        return self.n_frames

    def __iter__(self):
        for i in range(self.n_frames):
            yield [self.frame(i)]


class SyntheticNuScenesStream:
    """In-memory NuScenes-format observation dicts (the layout of
    dataloaders/nuscenes.NuScenesDataloader.read_obs) on the same world,
    with a parked car (a static tracked instance) and a car moving along
    the road at 1.5 m per frame (flagged dynamic by the tracker)."""

    def __init__(self, n_frames: int = 12, step: float = 2.0,
                 lidar_range: float = 25.0, seed: int = 0,
                 n_cams: int = 6, img_hw=(64, 128)):
        self.n_frames = n_frames
        self.step = step
        self.lidar_range = lidar_range
        self.n_cams = n_cams
        self.img_hw = img_hw
        rng = np.random.default_rng(seed)
        length = n_frames * step + 2 * lidar_range
        self.world, self.world_int, self.world_sem = _world_points(
            rng, length=length)
        # Moving car: a template cluster translating +x at 1.5 m / frame.
        n_car = 120
        self.mov_template = np.stack([
            rng.uniform(-2, 2, n_car), rng.uniform(-1, 1, n_car),
            rng.uniform(0.2, 1.5, n_car)], 1)
        self.mov_start = np.array([lidar_range + 6.0, 2.5, 0.0])
        self.mov_vel = np.array([1.5, 0.0, 0.0])
        # Parked car: a static tracked instance.
        self.parked_center = np.array([lidar_range + 14.0, -3.0, 0.6])
        self.parked_pts = self.parked_center + np.stack([
            rng.uniform(-2, 2, n_car), rng.uniform(-0.8, 0.8, n_car),
            rng.uniform(-0.4, 0.9, n_car)], 1)

    def ego_pose(self, idx: int) -> np.ndarray:
        return np.array([self.lidar_range + idx * self.step, 0.0, EGO_Z])

    def _project_fake(self, pts_ego):
        """Deterministic fake rig projection: the camera is the azimuth
        sector; (u, v) are linear in azimuth and elevation, strictly inside
        the image."""
        H, W = self.img_hw
        az = np.arctan2(pts_ego[:, 1], pts_ego[:, 0])  # [-pi, pi)
        frac = (az + np.pi) / (2 * np.pi)              # [0, 1)
        cam = np.minimum((frac * self.n_cams).astype(int), self.n_cams - 1)
        in_cam = frac * self.n_cams - cam              # [0, 1)
        u = 2.0 + in_cam * (W - 4)
        r = np.linalg.norm(pts_ego[:, :2], axis=1)
        el = np.clip(pts_ego[:, 2] / np.maximum(r, 1e-3), -1, 1)
        v = 2.0 + (el + 1) / 2 * (H - 4)
        return u, v, cam

    def render_images(self, idx: int) -> list:
        """One uint8 (H,W,3) gradient image per camera."""
        H, W = self.img_hw
        imgs = []
        for c in range(self.n_cams):
            img = np.zeros((H, W, 3), np.uint8)
            img[..., 0] = (40 * c + idx) % 256
            img[..., 1] = np.linspace(0, 255, H, dtype=np.uint8)[:, None]
            img[..., 2] = np.linspace(0, 255, W, dtype=np.uint8)[None, :]
            imgs.append(img)
        return imgs

    def frame(self, idx: int) -> dict:
        pose = self.ego_pose(idx)
        mov_center = self.mov_start + idx * self.mov_vel
        mov_pts = self.mov_template + mov_center
        pts_w = np.concatenate([self.world, self.parked_pts, mov_pts])
        inten = np.concatenate([
            self.world_int,
            np.full(self.parked_pts.shape[0], 0.6, np.float32),
            np.full(mov_pts.shape[0], 0.7, np.float32)])
        # Frame-local instance column: -1 none, 0 parked, 1 moving (the
        # order of inst_tokens below).
        inst = np.concatenate([
            -np.ones(self.world.shape[0]),
            np.zeros(self.parked_pts.shape[0]),
            np.ones(mov_pts.shape[0])])
        rel = pts_w - pose[None, :]
        m = np.linalg.norm(rel[:, :2], axis=1) < self.lidar_range
        rel, inten, inst = rel[m], inten[m], inst[m]
        u, v, cam = self._project_fake(rel)
        pc = np.concatenate([rel, (inten * 255)[:, None], u[:, None],
                             v[:, None], inst[:, None]], axis=1)
        T_ego_global = np.eye(4)
        T_ego_global[:3, 3] = pose
        return {
            'images': self.render_images(idx),
            'pc': pc.astype(np.float64),
            'pc_cam_idx': cam.astype(int),
            'ego_at_lidar_ts': T_ego_global,
            'inst_tokens': ['car_parked', 'car_moving'],
            'inst_cls': [0, 0],
            'inst_center': [self.parked_center.copy(), mov_center.copy()],
            'ego_global_x': pose[0],
            'ego_global_y': pose[1],
            'meta': {'sample_token': f'synth{idx}', 'scene_token': 'synth',
                     'cam_channels': [f'CAM{i}' for i in range(self.n_cams)]},
        }

    def __len__(self):
        return self.n_frames

    def __iter__(self):
        for i in range(self.n_frames):
            yield [self.frame(i)]


def write_kitti360_layout(root: str, seq: str = '2013_05_28_drive_0000_sync',
                          n_frames: int = 10, **kw) -> SyntheticKitti360Stream:
    """Write the stream as a KITTI-360 directory tree (calibration,
    velodyne .bin, rectified .png, raw label .bin), the layout the
    KITTI-360 dataloader reads. PIL is imported here only."""
    import os

    from PIL import Image
    stream = SyntheticKitti360Stream(n_frames=n_frames, **kw)
    H_cam_velo, _, P_cam_frame = make_calib()
    calib_dir = os.path.join(root, 'calibration')
    os.makedirs(calib_dir, exist_ok=True)
    np.savetxt(os.path.join(calib_dir, 'calib_cam_to_velo.txt'),
               H_cam_velo[:3].reshape(1, -1), delimiter=' ')
    with open(os.path.join(calib_dir, 'perspective.txt'), 'w') as f:
        vals = ' '.join(str(v) for v in P_cam_frame.reshape(-1))
        f.write('calib_time: synthetic\n')
        f.write(f'P_rect_00: {vals}\n')
    pc_dir = os.path.join(root, 'data_3d_raw', seq, 'velodyne_points', 'data')
    img_dir = os.path.join(root, 'data_2d_raw', seq, 'image_00', 'data_rect')
    sem_dir = os.path.join(root, 'data_3d_semantics', 'raw', seq, 'labels')
    for d in (pc_dir, img_dir, sem_dir):
        os.makedirs(d, exist_ok=True)
    for i in range(n_frames):
        img, pc, sem_gt = stream.frame(i)
        name = f'{i:010d}'
        pc.astype(np.float32).tofile(os.path.join(pc_dir, name + '.bin'))
        Image.fromarray(img).save(os.path.join(img_dir, name + '.png'))
        sem_gt.astype(np.int16).reshape(-1).tofile(
            os.path.join(sem_dir, name + '.bin'))
    return stream
