"""The reference of the NuScenes oracle cell, written from what an
oracle-pose sample is, on the same generated scenes.

A scene's world frame is its first ego frame. Per frame, in order:

  * tracking, from the generator's own object centres: every object of a
    tracked class (car, truck, construction vehicle, bus, motorcycle) gets
    an instance id in the order first seen (from 1); an instance is
    dynamic from the frame its centre has moved more than 1 m in x, y
    from where it was first seen;
  * paint: each lidar point takes the colour and the class of the nearest
    pixel (coordinates rounded half to even) of its own camera; points of
    no camera or of a filtered class are dropped; the rest go to the
    world frame with their intensity / 255 and their instance id;
  * from the second frame on, one sample at the frame before the newest
    (reference/bev.py) over every point painted so far, the points of
    dynamic instances left out; the ego trajectory splits at that frame
    (present: the poses before it), the dynamic instances' trajectories
    split by their observations (ts <= present, ts >= present, all; runs
    of consecutive frames, 2 poses or more; in world coordinates), the
    lane is taken relative to the present pose.

The points arrive as the configuration's float32 wire carries them; the
reference works in float64 from there, the control in float32 with TF32
matmul operands. The class maps that paint are the judged run's own
(``labels``): the reference's semseg judges them separately
(``judge_semseg``), since bfloat16 and float32 semseg differ on classes
near ties. Nothing here comes from the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.gen.nuscenes import make_scene
from portbench.reference import bev
from portbench.reference.precision import full_float32
from portbench.reference.semseg import RefSemseg

TRACKED = (0, 1, 2, 3, 5)
DYN_THRESH_M = 1.0
EGO_LIFT_M = 1.0     # the ego pose's height above its lidar frame


class Tracker:
    def __init__(self):
        self.ids = {}        # token -> instance id
        self.seen = {}       # id -> [(ts, centre (3,))]
        self.dynamic = set()

    def update(self, ts, tokens, classes, centres) -> dict:
        """{token: id} of this frame's tracked objects."""
        out = {}
        for tok, cls, c in zip(tokens, classes, centres):
            if cls not in TRACKED:
                continue
            gid = self.ids.setdefault(tok, len(self.ids) + 1)
            hist = self.seen.setdefault(gid, [])
            hist.append((ts, np.asarray(c, np.float64)))
            if np.hypot(*(hist[-1][1][:2] - hist[0][1][:2])) > DYN_THRESH_M:
                self.dynamic.add(gid)
            out[tok] = gid
        return out

    def trajs(self, start=-math.inf, end=math.inf) -> list:
        out = []
        for gid in sorted(self.dynamic):
            run, last = [], None
            for ts, c in self.seen[gid]:
                if not start <= ts <= end:
                    continue
                if last is not None and ts != last + 1:
                    out += [np.array(run)] if len(run) >= 2 else []
                    run = []
                run.append(c)
                last = ts
            out += [np.array(run)] if len(run) >= 2 else []
        return out


def _rigid_inverse(T):
    inv = np.eye(4)
    inv[:3, :3] = T[:3, :3].T
    inv[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return inv


def replay_scene(config, scene, g0, n, labels, device, control=False):
    """The scene's first ``n`` frames (global frame g0 on): (samples,
    the dynamic instance ids). ``labels`` {global frame: (cams, H, W)
    class map} paint."""
    dt = torch.float32 if control else torch.float64
    bevp = config['bev']
    filters = torch.tensor(config['semseg_filters'], device=device)
    view, P = float(bevp['view_size']), int(bevp['pixel_size'])
    tracker = Tracker()
    rows = {k: [] for k in ('xyz', 'frame', 'sem', 'inten', 'rgb', 'gid')}
    poses, samples = [], []
    T_global_world = lanes = None
    for i in range(n):
        obs = scene.frame(i, g0 + i)
        T_ego_global = np.asarray(obs['ego_at_lidar_ts'], np.float64)
        if T_global_world is None:
            T_global_world = _rigid_inverse(T_ego_global)
            lanes = [np.asarray(ln) @ T_global_world[:3, :3].T
                     + T_global_world[:3, 3] for ln in scene.lane()]
        T = T_global_world @ T_ego_global
        poses.append(T[:3, 3] + [0.0, 0.0, EGO_LIFT_M])
        centres = [T_global_world[:3, :3] @ np.asarray(c)
                   + T_global_world[:3, 3] for c in obs['inst_center']]
        ids = tracker.update(i, obs['inst_tokens'], obs['inst_cls'],
                             centres)
        tok_gid = torch.tensor([0] + [ids.get(t, 0)
                                      for t in obs['inst_tokens']],
                               device=device)
        pc = torch.from_numpy(np.asarray(obs['pc'], np.float32)).to(
            device, dt)
        cam = torch.from_numpy(np.asarray(obs['pc_cam_idx'])).to(device)
        imgs = torch.from_numpy(np.asarray(obs['images'])).to(device)
        lab = labels[g0 + i].to(device)
        C, H, W = lab.shape
        u = torch.round(pc[:, 4]).clamp(0, W - 1).long()
        v = torch.round(pc[:, 5]).clamp(0, H - 1).long()
        c = cam.clamp(0, C - 1).long()
        sem = lab[c, v, u].long()
        keep = (cam >= 0) & ~torch.isin(sem, filters)
        Tt = torch.from_numpy(T).to(device, dt)
        xyz = bev.matmul(pc[:, :3], Tt[:3, :3].T, control) + Tt[:3, 3]
        inst = pc[:, 6].long().clamp(-1, len(obs['inst_tokens']) - 1) + 1
        for k, val in (('xyz', xyz), ('sem', sem), ('inten', pc[:, 3] / 255),
                       ('rgb', imgs[c, v, u].to(dt)), ('gid', tok_gid[inst]),
                       ('frame', torch.full_like(sem, i))):
            rows[k].append(val[keep])
        if i == 0:
            continue
        pi = len(poses) - 2
        pts = {k: torch.cat(v) for k, v in rows.items()}
        dyn = torch.zeros(max(tracker.ids.values(), default=0) + 1,
                          dtype=torch.bool, device=device)
        dyn[sorted(tracker.dynamic)] = True
        origin = poses[pi]
        ego = np.array(poses) - origin
        rot = bev.heading_angle(ego[:pi])
        sample = bev.sample_maps(
            pts['xyz'], pts['frame'], pts['sem'], pts['inten'], pts['rgb'],
            dyn[pts['gid']], torch.from_numpy(origin).to(device, dt), rot,
            pi, bevp, control)
        for split, e, others in (('present', ego[:pi], tracker.trajs(end=pi)),
                                 ('future', ego[pi:],
                                  tracker.trajs(start=pi)),
                                 ('full', ego, tracker.trajs())):
            sample[f'trajs_{split}'] = [bev.traj_pixels(t, rot, view, P)
                                        for t in [e] + others]
        sample['gt_lanes'] = [t for t in (bev.traj_pixels(
            ln - origin, rot, view, P) for ln in lanes) if t.shape[0]]
        samples.append(sample)
    return samples, set(tracker.dynamic)


def replay(config, seeds, scenes, labels, device, control=False):
    """Every checked scene {scene: (first global frame, frames)}: {'samples':
    {scene: [dict]}, 'dynamic': {scene: set of ids}}."""
    samples, dynamic = {}, {}
    with torch.no_grad(), full_float32():
        for sc, (g0, n) in sorted(scenes.items()):
            scene = make_scene(config, seeds['stream'], sc)
            samples[sc], dynamic[sc] = replay_scene(config, scene, g0, n,
                                                    labels, device, control)
    return dict(samples=samples, dynamic=dynamic)


def frame_images(config, seeds, frames, device):
    """{global frame: (cams, H, W, 3) uint8 images on ``device``}."""
    F = config['scene_keyframes']
    out, cache = {}, {}
    for g in frames:
        sc = g // F
        if sc not in cache:
            cache[sc] = make_scene(config, seeds['stream'], sc)
        out[g] = torch.from_numpy(cache[sc].render_images(g)).to(device)
    return out


def judge_semseg(config, seeds, frames, label_sets, weights, device):
    """{name: {frame: (gap, share)}}: the reference semseg (float32, TF32
    off) over ``frames``, judging each label set's class maps."""
    ss = config['semseg']
    sem = RefSemseg(weights, ss['stage_sizes'], device)
    out = {n: {} for n in label_sets}
    with full_float32():
        for g, imgs in frame_images(config, seeds, frames, device).items():
            got = sem.judge(imgs, {n: ls[g] for n, ls in label_sets.items()})
            for n, v in got.items():
                out[n][g] = v
    return out


def control_labels(config, seeds, frames, weights, device):
    """The control's class maps (fp8 convolutions) of ``frames``."""
    ss = config['semseg']
    sem = RefSemseg(weights, ss['stage_sizes'], device, precision='fp8')
    return {g: sem.predict(imgs) for g, imgs in frame_images(
        config, seeds, frames, device).items()}


def inst_dyn_gap(table, dynamic) -> float:
    """Largest difference between the program's dynamic-instance table
    and the reference's dynamic ids (1 where flagged, else 0)."""
    ref = np.zeros(len(table))
    ids = sorted(dynamic)
    if ids and ids[-1] >= len(table):
        return math.inf
    ref[ids] = 1.0
    return float(np.abs(np.asarray(table, np.float64) - ref).max())


def dyn_table(dynamic, size) -> np.ndarray:
    """A dynamic-instance table of ``size`` ids (1 where flagged)."""
    out = np.zeros(size, np.float32)
    out[sorted(dynamic)] = 1.0
    return out
