"""Semantic BEV generator for the accum.step() path.

Counterpart of bev/sem_bev.py's SemBEVGenerator with the dense float16
fetch: host-drawn augmentation (numpy Generator, same draw order as the
JAX package, so one seed gives the same samples), one prepped raster per
sample on the device, one non-blocking device->host copy per sample, and
host-side trajectory processing and assembly of the output dicts.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu.ops import trajectory as traj_ops
from pc_accumulation_lib_tpu_torch.bev import core
from pc_accumulation_lib_tpu_torch.ops import warp as warp_ops

_MAP_KEYS = ('road', 'intensity', 'rgb', 'dynamic', 'elevation')


class SemBEVGenerator:
    """Augmented semantic BEV samples on ``device``; constructor argument
    order as the JAX package's."""

    def __init__(self, sem_idxs: dict, view_size: float, pixel_size: int,
                 max_trans_radius: float = 0., zoom_thresh: float = 0.,
                 do_warp: bool = False, int_scaler: float = 1.,
                 int_sep_scaler: float = 1., int_mid_threshold: float = 0.5,
                 height_filter: Optional[float] = None, rgb_fill: int = 0,
                 seed: Optional[int] = None, fetch_dtype: str = 'float16',
                 device='cpu'):
        if fetch_dtype != 'float16':
            raise NotImplementedError(
                f"fetch_dtype={fetch_dtype!r}: the port has the dense "
                "'float16' fetch only")
        self.sem_idxs = dict(sem_idxs)
        self.view_size = float(view_size)
        self.pixel_size = int(pixel_size)
        self.max_trans_radius = max_trans_radius
        self.zoom_thresh = zoom_thresh
        self.do_warp = do_warp
        self.height_filter = height_filter
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._prep_fn = core.make_prep_fn(self.sem_idxs)
        self._raster = core.make_prepped_raster_fn(
            self.view_size, self.pixel_size, int_scaler, int_sep_scaler,
            int_mid_threshold, rgb_fill)

    @property
    def do_aug(self) -> bool:
        return self.max_trans_radius > 0. or self.zoom_thresh > 0.

    def _draw_geom_aug(self):
        """Random rotation/translation/zoom."""
        rot_ang = 2 * np.pi * self._rng.random()
        trans_r = self.max_trans_radius * self._rng.random()
        trans_ang = 2 * np.pi * self._rng.random()
        zoom = float(np.clip(self._rng.normal(0, 0.1), -self.zoom_thresh,
                             self.zoom_thresh)) + 1.0
        return (rot_ang, trans_r * np.cos(trans_ang),
                trans_r * np.sin(trans_ang), zoom)

    def _draw_warp(self):
        """Random polynomial warp parameters; identity when do_warp is
        off."""
        P = self.pixel_size
        if not self.do_warp:
            return dict(a1=1.0, a2=0.0, b1=1.0, b2=0.0, i_mid=P // 2,
                        j_mid=P // 2, i_warp=P // 2, j_warp=P // 2,
                        active=False)
        i_mid = j_mid = P // 2
        i_warp, j_warp = warp_ops.get_random_warp_params(
            0.15, 0.30, P, P, rng=self._rng)
        a1, a2 = warp_ops.cal_warp_params(i_warp, i_mid, P - 1)
        b1, b2 = warp_ops.cal_warp_params(j_warp, j_mid, P - 1)
        return dict(a1=a1, a2=a2, b1=b1, b2=b2, i_mid=i_mid, j_mid=j_mid,
                    i_warp=i_warp, j_warp=j_warp, active=True)

    def prep_points(self, points, inst_dyn, pose_vec):
        """Once-per-step augmentation-invariant point prep
        (core.make_prep_fn)."""
        return self._prep_fn(points, inst_dyn, pose_vec)

    def generate_samples_device(self, valid, pt_frame_ids, pose_vec,
                                n_samples: int, gen_future: bool, trajs_fn,
                                prepped):
        """Dispatch ``n_samples`` augmented rasters of the prepped points.

        ``pose_vec`` (22,) is the device-side pose half of the raster
        parameters; ``trajs_fn`` is called in the returned finalize, after
        the caller has synced host poses, and returns the metric-space
        trajectory dict. Returns a zero-arg finalize yielding the list of
        BEV dicts."""
        if not self.do_aug:
            raise NotImplementedError(
                'generate_samples_device requires augmentation '
                '(max_trans_radius/zoom_thresh > 0)')
        hf = np.inf if self.height_filter is None else self.height_filter
        draws, aug9s = [], []
        for _ in range(n_samples):
            rot_ang, dx, dy, zoom = self._draw_geom_aug()
            w = self._draw_warp()
            aug9s.append([rot_ang, dx, dy, zoom, w['a1'], w['a2'], w['b1'],
                          w['b2'], hf])
            draws.append((rot_ang, dx, dy, zoom, w))
        aug = torch.from_numpy(np.asarray(aug9s, np.float32).reshape(-1, 9))
        if self.device.type == 'cuda':
            aug = aug.pin_memory().to(self.device, non_blocking=True)
        ref_xyz, packed, packed2 = prepped
        # Each stack starts its copy as soon as it is queued; with a CUDA
        # device the copies land in pinned host memory, and the event
        # marks when the last one is done.
        outs = [self._raster(ref_xyz, valid, pt_frame_ids, packed, packed2,
                             (pose_vec, aug[i]), gen_future).to(
                                 'cpu', non_blocking=True)
                for i in range(n_samples)]
        done = None
        if self.device.type == 'cuda':
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))

        def finalize() -> List[Dict]:
            trajs = trajs_fn()
            if done is not None:
                done.synchronize()
            return [self._assemble(o.numpy(), trajs, rot_ang, dx, dy,
                                   zoom * self.view_size, w, gen_future)
                    for o, (rot_ang, dx, dy, zoom, w) in zip(outs, draws)]

        return finalize

    def _process_trajs(self, traj_list, rot_ang, dx, dy, aug_view, w):
        """Transform + crop + pixelize + warp one list of trajectories."""
        out = []
        for t in traj_list:
            t = np.asarray(t, dtype=np.float64).reshape(-1, 3)
            t = traj_ops.geometric_transform_traj(t, rot_ang, dx, dy,
                                                  aug_view)
            out.append(traj_ops.pos2grid_traj(t, aug_view, self.pixel_size))
        if w['active']:
            out = warp_ops.warp_trajs(out, w['a1'], w['a2'], w['j_mid'],
                                      w['j_warp'], self.pixel_size)
        return out

    def _assemble(self, stack, trajs, rot_ang, dx, dy, aug_view, w,
                  gen_future) -> Dict:
        """Output BEV dict: 5 map families per split (float16) and the
        processed trajectories."""
        maps = core.unpack_maps(stack, gen_future)
        splits = ('present', 'future', 'full') if gen_future else ('present',)
        bev = {}
        for s in splits:
            for k in _MAP_KEYS:
                bev[f'{k}_{s}'] = np.ascontiguousarray(maps[f'{k}_{s}'])
        for s in splits:
            ego = trajs.get(f'ego_traj_{s}')
            others = trajs.get(f'other_trajs_{s}') or []
            tl = ([] if ego is None else [ego]) + list(others)
            bev[f'trajs_{s}'] = self._process_trajs(tl, rot_ang, dx, dy,
                                                    aug_view, w)
        return bev
