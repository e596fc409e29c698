"""Seeded NuScenes-format observation stream for the oracle-pose loop
(host numpy).

The benchmark's own copy of the port's dataloaders/synthetic.py
``SyntheticNuScenesStream``, with a point density setting and a camera
size of its own. A scene is one drive on its own world, with a parked
car (a static tracked instance) and a car moving along the road at 1.5 m
a frame (flagged dynamic by the tracker). Every frame's six images carry
the run's global frame index, so no two frames of a run repeat.
"""
from __future__ import annotations

import numpy as np

from portbench.gen.world import EGO_Z, world_points, world_scale


class NuScenesScene:
    """Observation dicts (the layout of the port's NuScenes dataloader
    ``read_obs``) of one scene of ``n_frames`` frames ``step`` metres
    apart; about ``points_per_frame`` world points within
    ``lidar_range`` of each pose; ``n_cams`` cameras of ``img_hw``."""

    def __init__(self, n_frames: int, step: float, lidar_range: float,
                 seed, points_per_frame: int, n_cams: int, img_hw):
        self.n_frames = n_frames
        self.step = step
        self.lidar_range = lidar_range
        self.n_cams = n_cams
        self.img_hw = tuple(img_hw)
        rng = np.random.default_rng(seed)
        length = n_frames * step + 2 * lidar_range
        scale = world_scale(points_per_frame, lidar_range, length)
        self.world, self.world_int, _ = world_points(
            rng, n_road=int(6000 * scale), n_side=int(1500 * scale),
            n_bld=int(2500 * scale), n_veg=int(800 * scale),
            n_car=int(600 * scale), length=length)
        n_car = 120
        self.mov_template = np.stack([
            rng.uniform(-2, 2, n_car), rng.uniform(-1, 1, n_car),
            rng.uniform(0.2, 1.5, n_car)], 1)
        self.mov_start = np.array([lidar_range + 6.0, 2.5, 0.0])
        self.mov_vel = np.array([1.5, 0.0, 0.0])
        self.parked_center = np.array([lidar_range + 14.0, -3.0, 0.6])
        self.parked_pts = self.parked_center + np.stack([
            rng.uniform(-2, 2, n_car), rng.uniform(-0.8, 0.8, n_car),
            rng.uniform(-0.4, 0.9, n_car)], 1)

    def ego_pose(self, idx: int) -> np.ndarray:
        return np.array([self.lidar_range + idx * self.step, 0.0, EGO_Z])

    def lane(self):
        """A straight lane centerline along the drive, in global
        coordinates."""
        x = np.linspace(0.0, self.ego_pose(self.n_frames - 1)[0]
                        + self.lidar_range, 200)
        return [np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)]

    def _project(self, pts_ego):
        """Deterministic rig projection: the camera is the azimuth
        sector; (u, v) are linear in azimuth and elevation, strictly
        inside the image."""
        H, W = self.img_hw
        az = np.arctan2(pts_ego[:, 1], pts_ego[:, 0])
        frac = (az + np.pi) / (2 * np.pi)
        cam = np.minimum((frac * self.n_cams).astype(int), self.n_cams - 1)
        in_cam = frac * self.n_cams - cam
        u = 2.0 + in_cam * (W - 4)
        r = np.linalg.norm(pts_ego[:, :2], axis=1)
        el = np.clip(pts_ego[:, 2] / np.maximum(r, 1e-3), -1, 1)
        v = 2.0 + (el + 1) / 2 * (H - 4)
        return u, v, cam

    def render_images(self, g: int) -> np.ndarray:
        """(n_cams, H, W, 3) uint8: per camera a constant red channel set
        by the camera and the global frame index ``g``, vertical and
        horizontal gradients in green and blue (shifted every 256
        frames)."""
        H, W = self.img_hw
        imgs = np.empty((self.n_cams, H, W, 3), np.uint8)
        shift = g // 256
        green = ((np.arange(H) * 255 // max(H - 1, 1)) + shift) % 256
        blue = ((np.arange(W) * 255 // max(W - 1, 1)) + 7 * shift) % 256
        for c in range(self.n_cams):
            imgs[c, ..., 0] = (40 * c + g) % 256
            imgs[c, ..., 1] = green[:, None].astype(np.uint8)
            imgs[c, ..., 2] = blue[None, :].astype(np.uint8)
        return imgs

    def frame(self, idx: int, g: int) -> dict:
        """Frame ``idx`` of the scene; ``g`` is its index in the run."""
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
        u, v, cam = self._project(rel)
        pc = np.concatenate([rel, (inten * 255)[:, None], u[:, None],
                             v[:, None], inst[:, None]], axis=1)
        T_ego_global = np.eye(4)
        T_ego_global[:3, 3] = pose
        return {
            'images': self.render_images(g),
            'pc': pc.astype(np.float64),
            'pc_cam_idx': cam.astype(int),
            'ego_at_lidar_ts': T_ego_global,
            'inst_tokens': ['car_parked', 'car_moving'],
            'inst_cls': [0, 0],
            'inst_center': [self.parked_center.copy(), mov_center.copy()],
            'ego_global_x': pose[0],
            'ego_global_y': pose[1],
            'meta': {'sample_token': f'frame{g}', 'scene_token': 'synth',
                     'cam_channels': [f'CAM{i}' for i in range(self.n_cams)]},
        }


def make_scene(config: dict, stream_seed: int, scene: int) -> NuScenesScene:
    """Scene ``scene`` of a run whose stream seed is ``stream_seed``: a
    world of its own, ``scene_keyframes`` frames of the configuration's
    stream and cameras."""
    s = config['stream']
    seed = int(np.random.SeedSequence(
        [int(stream_seed), 7919 * (scene + 1) % 2 ** 32]).generate_state(1)[0])
    return NuScenesScene(config['scene_keyframes'], s['step'],
                         s['lidar_range'], seed, s['points_per_frame'],
                         config['camera']['n_cams'],
                         config['camera']['img_hw'])
