"""Semantic BEV generator.

Counterpart of bev/sem_bev.py's SemBEVGenerator with the dense float16
fetch: host-drawn augmentation (numpy Generator, same draw order as the
JAX package, so one seed gives the same samples), one raster per sample on
the device, one non-blocking device->host copy per sample, and host-side
trajectory processing and assembly of the output dicts. Two device paths:
``generate_samples`` runs the classic raster over the flat point buffer
(integrate() + generate_bev(), and the standalone ``generate`` API on
numpy point dicts); ``generate_samples_device`` runs the prepped raster of
the step() path. On a mesh (``mesh``, built on the points axis's rank 0)
both run the tuple-form raster of a mesh engine instead
(parallel/sharded.py), which the other ranks of the axis serve.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch.bev import core
from pc_accumulation_lib_tpu_torch.ops import trajectory as traj_ops
from pc_accumulation_lib_tpu_torch.ops import warp as warp_ops

_MAP_KEYS = ('road', 'intensity', 'rgb', 'dynamic', 'elevation')


def _pad_bucket(n: int, minimum: int = 1024) -> int:
    """Round a capacity up to a power of two (at least ``minimum``)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _to_rows10(pc: np.ndarray) -> np.ndarray:
    """Normalize point rows to the 10-column layout (config.PT_*): (N,8)
    [..sem] gets zero inst and dyn columns, (N,9) [..sem, dyn] a zero inst
    column; (N,10) passes."""
    n, c = pc.shape
    if c == 10:
        return pc
    if c == 8:
        return np.concatenate([pc, np.zeros((n, 2))], axis=1)
    if c == 9:
        return np.concatenate(
            [pc[:, :8], np.zeros((n, 1)), pc[:, 8:9]], axis=1)
    raise ValueError(f'Expected 8-10 point feature columns, got {c}')


class SemBEVGenerator:
    """Augmented semantic BEV samples on ``device`` (the card unless the
    caller passes 'cpu'; nothing is allocated at construction);
    constructor argument order as the JAX package's.

    ``mesh``: a DeviceMesh with a 'points' axis (parallel/mesh.py); the
    rasters then run point-sharded over its ranks, the engine picked by
    ``mesh_impl``: 'tile' (cells stripe over the ranks, each row goes
    once to its cell's owner, the stripes' statistics come from the
    one-device stats stage), 'psum' (per-shard accumulators summed over
    the axis: the readable spec, whose rgb histograms are ~200 MB per
    split at P = 256) or 'auto' (tile where pixel_size^2 divides by the
    axis size, else psum). Built on the axis's rank 0; the other ranks
    run parallel/sharded.serve_mesh_rasters. ``close()`` ends its use of
    the mesh."""

    def __init__(self, sem_idxs: dict, view_size: float, pixel_size: int,
                 max_trans_radius: float = 0., zoom_thresh: float = 0.,
                 do_warp: bool = False, int_scaler: float = 1.,
                 int_sep_scaler: float = 1., int_mid_threshold: float = 0.5,
                 height_filter: Optional[float] = None, rgb_fill: int = 0,
                 seed: Optional[int] = None, fetch_dtype: str = 'float16',
                 mesh=None, mesh_impl: str = 'auto', device='cuda'):
        if fetch_dtype != 'float16':
            raise NotImplementedError(
                f"fetch_dtype={fetch_dtype!r}: the port has the dense "
                "'float16' fetch only (the sparse and quantized fetch is "
                "ROADMAP queue 1 item 4)")
        self.sem_idxs = dict(sem_idxs)
        self.view_size = float(view_size)
        self.pixel_size = int(pixel_size)
        self.max_trans_radius = max_trans_radius
        self.zoom_thresh = zoom_thresh
        self.do_warp = do_warp
        self.height_filter = height_filter
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._raster = core.make_raster_fn(
            self.view_size, self.pixel_size, self.sem_idxs, int_scaler,
            int_sep_scaler, int_mid_threshold, rgb_fill)
        self._prep_fn = core.make_prep_fn(self.sem_idxs)
        self._raster_prepped = core.make_prepped_raster_fn(
            self.view_size, self.pixel_size, int_scaler, int_sep_scaler,
            int_mid_threshold, rgb_fill)
        self.mesh_raster = None
        if mesh is not None:
            from pc_accumulation_lib_tpu_torch.parallel import sharded
            self.mesh_raster = sharded.MeshRasterClient(mesh, dict(
                view_size=self.view_size, pixel_size=self.pixel_size,
                sem_idxs=self.sem_idxs, int_scaler=int_scaler,
                int_sep_scaler=int_sep_scaler,
                int_mid_threshold=int_mid_threshold, rgb_fill=rgb_fill,
                mesh_impl=mesh_impl))

    def close(self):
        """End the generator's use of the mesh: read the tile engine's
        pending overflow checks (raises TileRouteOverflow) and release
        the workers' engine. Nothing to do on one device."""
        if self.mesh_raster is not None:
            self.mesh_raster.close()
            self.mesh_raster = None

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

    @staticmethod
    def _heading_rot_ang(ego_traj_present) -> float:
        """Heading-aligned rotation: the last present ego segment points
        up in the BEV."""
        rot_ang = 0.5 * np.pi
        if ego_traj_present is not None and len(ego_traj_present) > 1:
            dx = ego_traj_present[-1][0] - ego_traj_present[-2][0]
            dy = ego_traj_present[-1][1] - ego_traj_present[-2][1]
            rot_ang += np.arctan2(dy, dx)
        return float(np.pi - rot_ang)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _fetch(self, stacks, assemble_args, trajs, gen_future):
        """Start each stack's device->host copy now; the returned zero-arg
        finalize waits for the copies and assembles the BEV dicts.
        ``trajs`` is the trajectory dict or a zero-arg callable giving
        it."""
        outs = [o.to('cpu', non_blocking=True) for o in stacks]
        done = None
        if self.device.type == 'cuda':
            # With a CUDA device the copies land in pinned host memory; the
            # event marks when the last one is done.
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))

        def finalize() -> List[Dict]:
            tr = trajs() if callable(trajs) else trajs
            if done is not None:
                done.synchronize()
            return [self._assemble(o.numpy(), tr, rot_ang, dx, dy,
                                   zoom * self.view_size, w, gen_future)
                    for o, (rot_ang, dx, dy, zoom, w)
                    in zip(outs, assemble_args)]

        return finalize

    def generate_samples(self, points, valid, pt_frame_ids, inst_dyn,
                         base_params: core.RasterParams, trajs: Dict,
                         n_samples: int, gen_future: bool,
                         randomize: Optional[bool] = None,
                         async_fetch: bool = False):
        """``n_samples`` BEV dicts from device-resident flat points with
        the classic raster (core.make_raster_fn).

        Args:
          points/valid/pt_frame_ids/inst_dyn: flat tensors on the device.
          base_params: host RasterParams with the frame, window and origin
            fields set; the augmentation fields are drawn per sample.
          trajs: metric-space trajectories already in the BEV frame
            ({'ego_traj_present': (N,3), 'other_trajs_present': [...],
            ... future/full ..., optional 'gt_lanes': [...]}).
          randomize: override of the do_aug decision; without it the
            rotation is heading-aligned and nothing is translated or
            zoomed.
          async_fetch: return a zero-arg callable yielding the list; all
            device work and the copies are queued before it returns.
        """
        randomize = self.do_aug if randomize is None else randomize
        hf = np.inf if self.height_filter is None else self.height_filter
        draws, vecs = [], []
        for _ in range(n_samples):
            if randomize:
                rot_ang, dx, dy, zoom = self._draw_geom_aug()
            else:
                rot_ang = self._heading_rot_ang(trajs.get('ego_traj_present'))
                dx, dy, zoom = 0.0, 0.0, 1.0
            w = self._draw_warp()
            vecs.append(base_params._replace(
                rot_ang=float(rot_ang), trans_dx=float(dx),
                trans_dy=float(dy), zoom=float(zoom),
                warp_a1=float(w['a1']), warp_a2=float(w['a2']),
                warp_b1=float(w['b1']), warp_b2=float(w['b2']),
                height_thresh=float(hf)).pack())
            draws.append((rot_ang, dx, dy, zoom, w))
        vecs = list(self._to_device(np.stack(vecs))) if vecs else []
        stacks = self._raster_all(points, valid, pt_frame_ids, inst_dyn,
                                  vecs, gen_future)
        finalize = self._fetch(stacks, draws, trajs, gen_future)
        return finalize if async_fetch else finalize()

    def _raster_all(self, points, valid, pt_frame_ids, inst_dyn, params,
                    gen_future):
        """One classic-raster stack per entry of ``params``; on a mesh the
        flat rows are scattered over it once for all of them."""
        if not params:
            return []
        if self.mesh_raster is None:
            return [self._raster(points, valid, pt_frame_ids, inst_dyn, p,
                                 gen_future) for p in params]
        self.mesh_raster.shard(points, valid, pt_frame_ids, inst_dyn)
        return [self.mesh_raster(p, gen_future) for p in params]

    def prep_points(self, points, inst_dyn, pose_vec):
        """Once-per-step augmentation-invariant point prep
        (core.make_prep_fn)."""
        return self._prep_fn(points, inst_dyn, pose_vec)

    def generate_samples_device(self, valid, pt_frame_ids, pose_vec,
                                n_samples: int, gen_future: bool, trajs_fn,
                                prepped):
        """Dispatch ``n_samples`` augmented rasters of the prepped points
        (on a mesh: of the rows the caller scattered with
        ``mesh_raster.shard``; ``prepped`` is then None).

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
        aug = self._to_device(np.asarray(aug9s, np.float32).reshape(-1, 9))
        if self.mesh_raster is not None:
            stacks = [self.mesh_raster((pose_vec, aug[i]), gen_future)
                      for i in range(n_samples)]
        else:
            ref_xyz, packed, packed2 = prepped
            stacks = [self._raster_prepped(ref_xyz, valid, pt_frame_ids,
                                           packed, packed2,
                                           (pose_vec, aug[i]), gen_future)
                      for i in range(n_samples)]
        return self._fetch(stacks, draws, trajs_fn, gen_future)

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
        if trajs.get('gt_lanes') is not None:
            lanes = self._process_trajs(trajs['gt_lanes'], rot_ang, dx, dy,
                                        aug_view, w)
            bev['gt_lanes'] = [ln for ln in lanes if ln.shape[0] > 0]
        return bev

    # ------------------------------------------------------------------
    # Standalone API on numpy point dicts
    # ------------------------------------------------------------------
    def generate(self, pcs: Dict, trajs: Dict, rot_ang: float = 0.,
                 trans_dx: float = 0., trans_dy: float = 0.,
                 zoom_scalar: float = 1., do_warping: bool = False) -> Dict:
        """One BEV dict from numpy point dicts pcs = {'pc_present'[,
        'pc_future']} (8-10 columns) and metric-space ``trajs``. Without
        ``do_warping`` the rotation is heading-aligned and ``rot_ang`` is
        ignored."""
        points, valid, fids, gen_future = self._pack_pcs(pcs)
        if not do_warping:
            rot_ang = self._heading_rot_ang(trajs.get('ego_traj_present'))
        hf = np.inf if self.height_filter is None else self.height_filter
        w = self._draw_warp()
        params = core.identity_params(window=(0, 1), present_frame=1,
                                      height_thresh=hf)._replace(
            rot_ang=float(rot_ang), trans_dx=float(trans_dx),
            trans_dy=float(trans_dy), zoom=float(zoom_scalar),
            warp_a1=float(w['a1']), warp_a2=float(w['a2']),
            warp_b1=float(w['b1']), warp_b2=float(w['b2']))
        inst_dyn = torch.zeros((1,), dtype=torch.float32, device=self.device)
        stack = self._raster_all(points, valid, fids, inst_dyn,
                                 [self._to_device(params.pack())],
                                 gen_future)[0]
        return self._fetch([stack], [(rot_ang, trans_dx, trans_dy,
                                      zoom_scalar, w)], trajs,
                           gen_future)()[0]

    def generate_rand_aug(self, pcs: Dict, trajs: Dict,
                          do_warping: bool = True) -> Dict:
        """generate() with a random rotation, translation and zoom."""
        rot_ang, dx, dy, zoom = self._draw_geom_aug()
        return self.generate(pcs, trajs, rot_ang, dx, dy, zoom, do_warping)

    def generate_multiproc(self, bev_gen_inputs) -> Dict:
        """(pcs, trajs) -> generate_rand_aug with augmentation, generate
        otherwise."""
        pcs, trajs = bev_gen_inputs
        if self.do_aug:
            return self.generate_rand_aug(pcs, trajs)
        return self.generate(pcs, trajs)

    def _pack_pcs(self, pcs: Dict):
        """pc_present/pc_future -> one flat buffer padded to a power of two
        with pseudo frame ids 0 (present) / 1 (future), on the device."""
        pc_p = _to_rows10(np.asarray(pcs['pc_present'], np.float32))
        pc_f = pcs.get('pc_future')
        gen_future = pc_f is not None
        if gen_future:
            pc_f = _to_rows10(np.asarray(pc_f, np.float32))
            flat = np.concatenate([pc_p, pc_f], axis=0)
            fids = np.concatenate([np.zeros(pc_p.shape[0], np.int32),
                                   np.ones(pc_f.shape[0], np.int32)])
        else:
            flat = pc_p
            fids = np.zeros(pc_p.shape[0], np.int32)
        n = flat.shape[0]
        cap = _pad_bucket(n)
        flat = np.pad(flat, ((0, cap - n), (0, 0))).astype(np.float32)
        fids = np.pad(fids, (0, cap - n))
        valid = np.arange(cap) < n
        return (self._to_device(flat), self._to_device(valid),
                self._to_device(fids), gen_future)

    # ------------------------------------------------------------------
    # Elevation-based static/dynamic partition (host numpy)
    # ------------------------------------------------------------------
    def get_elevation_map(self, pc: np.ndarray):
        """Per-cell min-z map from pixel-coordinate points: pc[:, 0] = i,
        pc[:, 1] = j, pc[:, 2] = z; rows flip (j_rev = P-1-j). Returns
        (elevmap (P,P), observed mask)."""
        P = self.pixel_size
        i = pc[:, 0].astype(int)
        j_rev = P - 1 - pc[:, 1].astype(int)
        elevmap = np.full((P, P), np.inf)
        np.minimum.at(elevmap, (j_rev, i), pc[:, 2])
        obs_mask = np.isfinite(elevmap)
        elevmap[~obs_mask] = 0.0
        return elevmap, obs_mask

    def static_obj_partitioning_by_elev(self, pc: np.ndarray,
                                        elev_thresh: float):
        """Flag points more than ``elev_thresh`` above their cell's min z
        as dynamic (pc[:, 8] = 1, in place). Returns (pc_static,
        pc_dynamic, elevmap, elevmap_obs_mask)."""
        P = self.pixel_size
        elevmap, obs_mask = self.get_elevation_map(pc)
        i = pc[:, 0].astype(int)
        j_rev = P - 1 - pc[:, 1].astype(int)
        above = pc[:, 2] > elevmap[j_rev, i] + elev_thresh
        pc[above, 8] = 1
        return (pc[pc[:, 8] == 0], pc[pc[:, 8] == 1], elevmap, obs_mask)

    def viz_bev(self, bev, file_path, rgbs=None, semsegs=None):
        """PNG of one BEV dict (bev/viz.py, matplotlib; imported only
        here)."""
        from pc_accumulation_lib_tpu_torch.bev import viz
        viz.viz_bev(bev, file_path, self.pixel_size, self.height_filter,
                    rgbs or [], semsegs or [])
