"""Semantic BEV generator.

Counterpart of bev/sem_bev.py's SemBEVGenerator: host-drawn augmentation
(numpy Generator, same draw order as the JAX package, so one seed gives the
same samples), one raster per sample on the device, the device->host
copies started at dispatch, and host-side trajectory processing and
assembly of the output dicts. Two device paths: ``generate_samples`` runs
the classic raster over the flat point buffer (integrate() +
generate_bev(), and the standalone ``generate`` API on numpy point dicts);
``generate_samples_device`` runs the prepped raster of the step() path. On
a mesh (``mesh``, built on the points axis's rank 0) both run the
tuple-form raster of a mesh engine instead (parallel/sharded.py), which
the other ranks of the axis serve.

The fetch encodings (``fetch_dtype``): 'float16' (the exact output),
'quantized' (the [0,1] channels as u8, elevation float16) and 'sparse'
(occupied cells only, shipped before the warp, decoded and warped on the
host by bev/native_decode, with the dense-words fallback on capacity
overflow). The sparse step() path dispatches a fetch group of rasters into
one stacked buffer, copies each group's per-sample occupied counts at
dispatch and the used prefix once they land ('exact' sizing), and decodes
on a persistent 2-thread pool.
"""
from __future__ import annotations

import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch.bev import core, native_decode
from pc_accumulation_lib_tpu_torch.ops import geometry
from pc_accumulation_lib_tpu_torch.ops import trajectory as traj_ops
from pc_accumulation_lib_tpu_torch.ops import warp as warp_ops
from pc_accumulation_lib_tpu_torch.utils import profiling

_MAP_KEYS = ('road', 'intensity', 'rgb', 'dynamic', 'elevation')
FETCH_DTYPES = ('float16', 'quantized', 'sparse')


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


def _to_host(t: torch.Tensor):
    """Start ``t``'s copy to the host: (host tensor, event marking its
    end). On the CPU the tensor is its own host copy and the event None."""
    if t.device.type != 'cuda':
        return t, None
    host = t.contiguous().to('cpu', non_blocking=True)   # pinned
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def _landed(copy) -> bool:
    return copy[1] is None or copy[1].query()


def _host(copy) -> np.ndarray:
    """Wait for a _to_host copy; its numpy view."""
    if copy[1] is not None:
        copy[1].synchronize()
    return copy[0].numpy()


def _row_getter(buf: torch.Tensor, i: int):
    """Lazy fetch of one row of a stacked group buffer (the sparse path's
    refetch and overflow fallbacks)."""
    return lambda: buf[i].cpu().numpy()


class _ExactFetch(NamedTuple):
    """A sparse group fetch sized from the occupied counts: the stacked
    (G, bytes) device buffer, the copy of its per-sample count blocks
    started at dispatch, and the (bytes, copy) of the prefix the byte hint
    predicted, started at dispatch too (None without a hint)."""
    group: torch.Tensor
    counts: tuple
    pre: Optional[tuple]


class SemBEVGenerator:
    """Augmented semantic BEV samples on ``device`` (the card unless the
    caller passes 'cpu'; nothing is allocated at construction);
    constructor argument order as the JAX package's up to ``seed``.

    ``fetch_dtype``: 'float16', 'quantized' or 'sparse' (module
    docstring); ``sparse_cap``: int or (present, future, full-delta)
    occupied-cell caps of the sparse buffer (None: 60% of the raster);
    ``fetch_group``: samples per stacked sparse dispatch and fetch of
    generate_samples_device.

    ``mesh``: a DeviceMesh with a 'points' axis (parallel/mesh.py); the
    rasters then run point-sharded over its ranks, the engine picked by
    ``mesh_impl``: 'tile' (cells stripe over the ranks, each row goes
    once to its cell's owner, the stripes' statistics come from the
    one-device stats stage), 'psum' (per-shard accumulators summed over
    the axis: the readable spec, whose rgb histograms are ~200 MB per
    split at P = 256) or 'auto' (tile where pixel_size^2 divides by the
    axis size, else psum). Built on the axis's rank 0; the other ranks
    run parallel/sharded.serve_mesh_rasters. ``close()`` ends its use of
    the mesh and the harvest pool."""

    def __init__(self, sem_idxs: dict, view_size: float, pixel_size: int,
                 max_trans_radius: float = 0., zoom_thresh: float = 0.,
                 do_warp: bool = False, int_scaler: float = 1.,
                 int_sep_scaler: float = 1., int_mid_threshold: float = 0.5,
                 height_filter: Optional[float] = None, rgb_fill: int = 0,
                 seed: Optional[int] = None, fetch_dtype: str = 'float16',
                 mesh=None, mesh_impl: str = 'auto', device='cuda',
                 sparse_cap=None, fetch_group: int = 4):
        if fetch_dtype not in FETCH_DTYPES:
            raise ValueError(f'fetch_dtype must be one of {FETCH_DTYPES}, '
                             f'got {fetch_dtype!r}')
        self.sem_idxs = dict(sem_idxs)
        self.view_size = float(view_size)
        self.pixel_size = int(pixel_size)
        self.max_trans_radius = max_trans_radius
        self.zoom_thresh = zoom_thresh
        self.do_warp = do_warp
        self.int_scaler = int_scaler
        self.int_sep_scaler = int_sep_scaler
        self.int_mid_threshold = int_mid_threshold
        self.height_filter = height_filter
        self.rgb_fill = rgb_fill
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self.fetch_dtype = fetch_dtype
        self.fetch_group = max(1, int(fetch_group))
        self.sparse_cap = (core.default_sparse_cap(self.pixel_size)
                           if sparse_cap is None else
                           core.resolve_sparse_caps(sparse_cap)
                           if isinstance(sparse_cap, (tuple, list))
                           else int(sparse_cap))
        # Sparse-fetch telemetry (the JAX package's names): fallbacks to
        # the dense words, the largest occupancy (overall and per split),
        # the per-split sums over n_occupied_obs samples, refetches of a
        # truncated fetch, and the byte hint per split count. A harvest's
        # waits, decode time and wire bytes are spans and counters
        # (utils/profiling.py).
        self.sparse_overflows = 0
        self.max_occupied = 0
        self.max_occupied_split = [0, 0, 0]
        self.sum_occupied_split = [0, 0, 0]
        self.n_occupied_obs = 0
        self.sparse_short_fetches = 0
        self._fetch_hint_bytes = {}        # {S: bytes}
        self._step_used_max = {}           # {S: bytes}
        self._step_used_n = {}             # {S: samples this step}
        self._prev_step_used_max = {}      # {S: bytes}
        # 'exact': each group's counts are copied at dispatch and its
        # used prefix once they land (a hint-sized prefix is copied at
        # dispatch too, topped up on a miss); 'hint': one copy at
        # dispatch, truncated at the hint (a miss refetches the sample's
        # whole buffer). Lossless either way.
        self.fetch_sizing = 'exact'
        self._pending_fetches = []         # exact groups not yet sized
        self._harvest_pool = None
        self._pool_finalizer = None
        self._telemetry_lock = threading.Lock()
        self._sparse_empty = core.sparse_empty_values(
            int_scaler, int_sep_scaler, int_mid_threshold, rgb_fill)
        # Rank-compacted stats groups on the sparse prepped path: None =
        # on wherever the sparse fetch is; read at every dispatch.
        self.raster_compact: Optional[bool] = None
        # Per-sample dispatch even where the grouped one applies.
        self._force_ungrouped_dispatch = False
        pack = 'sparse' if fetch_dtype == 'sparse' else None
        self._pack = pack
        self._raster = core.make_raster_fn(
            self.view_size, self.pixel_size, self.sem_idxs, int_scaler,
            int_sep_scaler, int_mid_threshold, rgb_fill, pack=pack,
            sparse_cap=self.sparse_cap)
        self._prep_fn = core.make_prep_fn(self.sem_idxs)
        self._prepped_fns = {}             # {(grouped, compact): fn}
        self.mesh_raster = None
        if mesh is not None:
            from pc_accumulation_lib_tpu_torch.parallel import sharded
            self.mesh_raster = sharded.MeshRasterClient(mesh, dict(
                view_size=self.view_size, pixel_size=self.pixel_size,
                sem_idxs=self.sem_idxs, int_scaler=int_scaler,
                int_sep_scaler=int_sep_scaler,
                int_mid_threshold=int_mid_threshold, rgb_fill=rgb_fill,
                mesh_impl=mesh_impl, pack=pack, sparse_cap=self.sparse_cap))

    def close(self):
        """End the generator's use of the mesh (read the tile engine's
        pending overflow checks, which raises TileRouteOverflow, and
        release the workers' engine) and shut the harvest pool down."""
        try:
            if self.mesh_raster is not None:
                self.mesh_raster.close()
                self.mesh_raster = None
        finally:
            if self._pool_finalizer is not None:
                self._pool_finalizer()
                self._pool_finalizer = None
            self._harvest_pool = None

    @property
    def do_aug(self) -> bool:
        return self.max_trans_radius > 0. or self.zoom_thresh > 0.

    @property
    def _compact_groups(self) -> bool:
        if self.raster_compact is not None:
            return bool(self.raster_compact) and self.fetch_dtype == 'sparse'
        return self.fetch_dtype == 'sparse'

    def prepped_raster(self, grouped: bool = False):
        """The prepped raster (core.make_prepped_raster_fn), or its fetch
        group form, at this dispatch's raster_compact setting."""
        key = (grouped, self._compact_groups)
        fn = self._prepped_fns.get(key)
        if fn is None:
            make = (core.make_prepped_raster_group_fn if grouped
                    else core.make_prepped_raster_fn)
            fn = make(self.view_size, self.pixel_size, self.int_scaler,
                      self.int_sep_scaler, self.int_mid_threshold,
                      self.rgb_fill, pack=self._pack,
                      sparse_cap=self.sparse_cap, compact_groups=key[1])
            self._prepped_fns[key] = fn
        return fn

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

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------
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
                rot_ang = geometry.heading_rot_ang(
                    trajs.get('ego_traj_present'))
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
        outs = self._raster_all(points, valid, pt_frame_ids, inst_dyn, vecs,
                                gen_future)
        finalize = self._harvest(outs, draws, trajs, gen_future)
        return finalize if async_fetch else finalize()

    def _raster_all(self, points, valid, pt_frame_ids, inst_dyn, params,
                    gen_future):
        """One classic-raster output per entry of ``params`` (a 'raster'
        span each); on a mesh the flat rows are scattered over it once
        for all of them."""
        if not params:
            return []
        if self.mesh_raster is not None:
            self.mesh_raster.shard(points, valid, pt_frame_ids, inst_dyn)
        outs = []
        for p in params:
            with profiling.span('raster', device=True):
                outs.append(
                    self._raster(points, valid, pt_frame_ids, inst_dyn, p,
                                 gen_future) if self.mesh_raster is None
                    else self.mesh_raster(p, gen_future))
        return outs

    def prep_points(self, points, inst_dyn, pose_vec):
        """Once-per-step augmentation-invariant point prep
        (core.make_prep_fn)."""
        return self._prep_fn(points, inst_dyn, pose_vec)

    def generate_samples_device(self, valid, pt_frame_ids, pose_vec,
                                n_samples: int, gen_future: bool, trajs_fn,
                                prepped, fetch_group: Optional[int] = None):
        """Dispatch ``n_samples`` augmented rasters of the prepped points
        (on a mesh: of the rows the caller scattered with
        ``mesh_raster.shard``; ``prepped`` is then None).

        ``pose_vec`` (22,) is the device-side pose half of the raster
        parameters; ``trajs_fn`` is called in the returned finalize, after
        the caller has synced host poses, and returns the metric-space
        trajectory dict. With the sparse fetch and more than one sample,
        each fetch group of ``fetch_group`` samples (None: the
        generator's) is one stacked raster dispatch and one copy (the
        tile engine's ``group`` on a mesh). Returns a zero-arg finalize
        yielding the list of BEV dicts."""
        fetch_group = max(1, self.fetch_group if fetch_group is None
                          else int(fetch_group))
        # Size every earlier sparse group whose counts have landed: its
        # value copy queues ahead of this call's rasters.
        self.resolve_ready_fetches()
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
        sparse = self.fetch_dtype == 'sparse'
        mesh = self.mesh_raster
        if (sparse and n_samples > 1 and not self._force_ungrouped_dispatch
                and (mesh is None or mesh.has_group)):
            if mesh is not None:
                def run(a):
                    return mesh.group(pose_vec, a, gen_future)
            else:
                gfn = self.prepped_raster(grouped=True)

                def run(a):
                    return gfn(prepped[0], valid, pt_frame_ids, prepped[1],
                               prepped[2], pose_vec, a, gen_future)
            outs, groups = [], []
            for g0 in range(0, n_samples, fetch_group):
                with profiling.span('raster', device=True):
                    sp, dn = run(aug[g0:g0 + fetch_group])
                with profiling.span('fetch'):
                    groups.append(self._start_fetch(sp, gen_future))
                outs += [(_row_getter(sp, i), _row_getter(dn, i))
                         for i in range(sp.shape[0])]
            return self._make_device_finalize(outs, draws, groups,
                                              fetch_group, n_samples,
                                              gen_future, trajs_fn)
        if mesh is None:
            ref_xyz, packed, packed2 = prepped
            raster = self.prepped_raster()
        outs = []
        for i in range(n_samples):
            with profiling.span('raster', device=True):
                outs.append(
                    mesh((pose_vec, aug[i]), gen_future) if mesh is not None
                    else raster(ref_xyz, valid, pt_frame_ids, packed,
                                packed2, (pose_vec, aug[i]), gen_future))
        if not sparse:
            return self._fetch(self._encode_outs(outs), draws, trajs_fn,
                               gen_future)
        groups = []
        for g0 in range(0, n_samples, fetch_group):
            with profiling.span('pack', device=True):
                stacked = torch.stack([o[0] for o in
                                       outs[g0:g0 + fetch_group]])
            with profiling.span('fetch'):
                groups.append(self._start_fetch(stacked, gen_future))
        return self._make_device_finalize(outs, draws, groups, fetch_group,
                                          n_samples, gen_future, trajs_fn)

    # ------------------------------------------------------------------
    # Fetch
    # ------------------------------------------------------------------
    def _encode_outs(self, outs):
        """The quantized encoding of freshly dispatched float16 stacks
        (the sparse raster's outputs come encoded)."""
        if self.fetch_dtype == 'quantized':
            with profiling.span('pack', device=True):
                return [core.quantize_stack(s) for s in outs]
        return outs

    def _harvest(self, outs, draws, trajs, gen_future):
        """Zero-arg finalize of classic-raster outputs: float16 and
        quantized stacks through _fetch; sparse buffers each copied now,
        truncated at the byte hint, and decoded in turn."""
        if self.fetch_dtype != 'sparse':
            return self._fetch(self._encode_outs(outs), draws, trajs,
                               gen_future)
        with profiling.span('fetch'):
            copies = [self._start_fetch(o[0], gen_future) for o in outs]

        def finalize() -> List[Dict]:
            tr = trajs() if callable(trajs) else trajs
            res = []
            for o, c, (rot_ang, dx, dy, zoom, w) in zip(outs, copies, draws):
                with profiling.span('sync.fetch'):
                    raw = _host(c)
                res.append(self._assemble(
                    self._fetch_stack(o, gen_future, w, raw=raw), tr,
                    rot_ang, dx, dy, zoom * self.view_size, w, gen_future))
            self._note_step_boundary()
            profiling.count('fetch.bytes', sum(c[0].numel() for c in copies))
            return res

        return finalize

    def _fetch(self, stacks, assemble_args, trajs, gen_future):
        """Start each float16 or quantized stack's device->host copy now;
        the returned zero-arg finalize waits for the copies and assembles
        the BEV dicts. ``trajs`` is the trajectory dict or a zero-arg
        callable giving it. Span 'fetch' and counter 'fetch.bytes' here,
        span 'sync.fetch' for the wait."""
        with profiling.span('fetch'):
            outs = [o.to('cpu', non_blocking=True) for o in stacks]
            done = None
            if self.device.type == 'cuda':
                # With a CUDA device the copies land in pinned host memory;
                # the event marks when the last one is done.
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        profiling.count('fetch.bytes',
                        sum(o.numel() * o.element_size() for o in outs))

        def finalize() -> List[Dict]:
            tr = trajs() if callable(trajs) else trajs
            with profiling.span('sync.fetch'):
                if done is not None:
                    done.synchronize()
            return [self._assemble(self._fetch_stack(o.numpy(), gen_future),
                                   tr, rot_ang, dx, dy,
                                   zoom * self.view_size, w, gen_future)
                    for o, (rot_ang, dx, dy, zoom, w)
                    in zip(outs, assemble_args)]

        return finalize

    def _make_device_finalize(self, outs, draws, groups, fetch_group,
                              n_samples, gen_future, trajs_fn):
        """Deferred harvest of sparse group fetches: size and wait for
        each group's copy (spans 'sync.fetch'), decode + warp + assemble
        its samples on the harvest pool (spans 'harvest.decode' of the
        caller's frame), update the byte hint; counters 'fetch.bytes' and
        'fetch.resolved_by.<where the groups were sized>'."""
        holder = {'groups': groups, 'gen_future': gen_future,
                  'resolved': None, 'wire': 0, 'lock': threading.Lock()}
        if any(isinstance(g, _ExactFetch) for g in groups):
            self._pending_fetches.append(holder)

        def finalize() -> List[Dict]:
            trajs = trajs_fn()
            frame = profiling.current_frame()

            def work(o, draw, raw):
                with profiling.span('harvest.decode', frame):
                    rot_ang, dx, dy, zoom, w = draw
                    return self._assemble(
                        self._fetch_stack(o, gen_future, w, raw=raw), trajs,
                        rot_ang, dx, dy, zoom * self.view_size, w,
                        gen_future)

            with profiling.span('sync.fetch'):
                resolved, wire = self._resolve_fetch_groups(holder)
            try:
                self._pending_fetches.remove(holder)
            except ValueError:
                pass
            futs = []
            pool = self._pool()
            for gi, g0 in enumerate(range(0, n_samples, fetch_group)):
                with profiling.span('sync.fetch'):
                    raws = _host(resolved[gi])
                for j in range(g0, min(g0 + fetch_group, n_samples)):
                    futs.append(pool.submit(work, outs[j], draws[j],
                                            raws[j - g0]))
            res = [f.result() for f in futs]
            self._note_step_boundary()
            profiling.count('fetch.bytes', wire)
            profiling.count(f'fetch.resolved_by.{holder["resolved_by"]}')
            return res

        return finalize

    def _pool(self) -> ThreadPoolExecutor:
        """The persistent 2-thread harvest pool: a pool per step would
        retire its threads and their native decoder's thread-local tables
        each time. It is shut down with the generator (weakref, so the
        pool does not keep the generator alive) or by close()."""
        if self._harvest_pool is None:
            self._harvest_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix='bev-decode')
            self._pool_finalizer = weakref.finalize(
                self, ThreadPoolExecutor.shutdown, self._harvest_pool,
                wait=False)
        return self._harvest_pool

    def _note_step_boundary(self):
        """Update the byte hint of each split count from this step's
        largest used bytes: +10% headroom and twice the step-over-step
        growth (the hint trails dispatch by a step or two while the window
        fills), rounded up to 16 KiB. A step of 1-3 samples never shrinks
        it (its maximum is biased low)."""
        with self._telemetry_lock:
            for S, cur in self._step_used_max.items():
                prev = self._prev_step_used_max.get(S)
                if (prev is not None and cur < prev
                        and self._step_used_n.get(S, 0) < 4):
                    continue
                slope = 0 if prev is None else max(0, cur - prev)
                hint = int((cur + 2 * slope) * 1.10)
                self._fetch_hint_bytes[S] = -(-hint // 16384) * 16384
                self._prev_step_used_max[S] = cur
            self._step_used_max.clear()
            self._step_used_n.clear()

    def _start_fetch(self, buf, gen_future=True):
        """Begin the device->host copy of one sparse buffer (1-D) or a
        stacked group of them (G, bytes). 'exact' sizing of a group: copy
        its per-sample count blocks now, and the prefix the byte hint
        predicts when there is one; _resolve_fetch_groups sizes the rest
        once the counts land (an _ExactFetch). Otherwise one copy,
        truncated at the hint: a (host, event) pair."""
        S = 3 if gen_future else 1
        hint = self._fetch_hint_bytes.get(S)
        if self.fetch_sizing == 'exact' and buf.dim() >= 2:
            off = core.sparse_header_bytes(self.pixel_size, gen_future) - 16
            counts = _to_host(buf[:, off:off + 4 * S])
            pre = None
            if hint is not None:
                k = min(hint, buf.shape[-1])
                pre = (k, _to_host(buf[:, :k]))
            return _ExactFetch(buf, counts, pre)
        if hint is not None and hint < buf.shape[-1]:
            buf = buf[..., :hint]
        return _to_host(buf)

    def _resolve_fetch_groups(self, holder):
        """The host copies of a fetch set's groups. An _ExactFetch: read
        its count blocks, take the prefix copied at dispatch if it covers the
        group's largest used bytes, else copy exactly the used prefix now
        (a hint miss, counted in sparse_short_fetches). Idempotent; a
        finalize racing resolve_ready_fetches takes holder['lock']."""
        with holder['lock']:
            if holder['resolved'] is not None:
                return holder['resolved'], holder['wire']
            gen_future = holder['gen_future']
            S = 3 if gen_future else 1
            hdr = core.sparse_header_bytes(self.pixel_size, gen_future)
            resolved, wire = [], 0
            for g in holder['groups']:
                if not isinstance(g, _ExactFetch):
                    resolved.append(g)
                    wire += g[0].numel()
                    continue
                G = g.group.shape[0]
                noccs = _host(g.counts).view(np.int32).reshape(G, S)
                used = hdr + 8 * int(noccs.sum(axis=1).max())
                if g.pre is not None:
                    k, copy = g.pre
                    wire += G * k
                    if k >= used:
                        resolved.append(copy)
                        continue
                    with self._telemetry_lock:
                        self.sparse_short_fetches += 1
                resolved.append(_to_host(g.group[:, :used]))
                wire += G * used
            holder['resolved'], holder['wire'] = resolved, wire
            holder.setdefault('resolved_by', 'finalize')
            return resolved, wire

    def resolve_ready_fetches(self):
        """Size every pending 'exact' fetch set whose count blocks have
        landed, without waiting. Called at dispatch entry (step(),
        generate_samples_device) so the value copies queue while the
        device is idle. No-op when nothing is pending."""
        if not self._pending_fetches:
            return
        for holder in list(self._pending_fetches):
            if holder['resolved'] is not None:
                continue
            if all(_landed(g.counts) for g in holder['groups']
                   if isinstance(g, _ExactFetch)):
                holder.setdefault('resolved_by', 'dispatch')
                self._resolve_fetch_groups(holder)
        self._pending_fetches = [h for h in list(self._pending_fetches)
                                 if h['resolved'] is None]

    def _fetch_stack(self, out, gen_future, w=None, raw=None) -> np.ndarray:
        """One raster output -> (C,P,P) float16 numpy stack, per
        fetch_dtype: a float16 stack passes; a quantized buffer is
        dequantized; a sparse (buffer, fallback) pair (tensors or lazy
        getters) is decoded from ``raw`` (its fetched bytes; None fetches
        them) and warped by ``w`` on the host, with the dense fallback on
        capacity overflow and a whole refetch of a truncated fetch."""
        if self.fetch_dtype == 'float16':
            return out
        if self.fetch_dtype == 'quantized':
            return core.dequantize_stack_batch(
                np.asarray(out)[None], gen_future, self.pixel_size)[0]
        sparse, dense = out
        fetch_full = (sparse if callable(sparse)
                      else lambda: sparse.cpu().numpy())
        fetch_dense = (dense if callable(dense)
                       else lambda: dense.cpu().numpy())
        if raw is None:
            raw = fetch_full()
        P = self.pixel_size
        S = 3 if gen_future else 1
        if raw.shape[-1] < core.sparse_header_bytes(P, gen_future):
            # A truncation below the fixed header (a hint learned at
            # another operating point): fetch the whole buffer first.
            with self._telemetry_lock:
                self.sparse_short_fetches += 1
            raw = fetch_full()
        n_occs = core.read_sparse_noccs(raw, P, gen_future)
        used = core.sparse_used_bytes(raw, P, gen_future)
        with self._telemetry_lock:
            self.max_occupied = max(self.max_occupied, int(n_occs.max()))
            self.n_occupied_obs += 1
            for i in range(S):
                self.max_occupied_split[i] = max(
                    self.max_occupied_split[i], int(n_occs[i]))
                self.sum_occupied_split[i] += int(n_occs[i])
            self._step_used_max[S] = max(self._step_used_max.get(S, 0),
                                         used)
            self._step_used_n[S] = self._step_used_n.get(S, 0) + 1

        def decode(r):
            return native_decode.decode_sparse_warp(
                r, gen_future, P, self.sparse_cap, self._sparse_empty, w)

        try:
            try:
                return decode(raw)
            except core.SparseShortFetch:
                with self._telemetry_lock:
                    self.sparse_short_fetches += 1
                return decode(fetch_full())
        except core.SparseOverflow:
            with self._telemetry_lock:
                self.sparse_overflows += 1
            stack = core.decode_dense_words(fetch_dense(), gen_future, P)
            if w is not None and w['active']:
                stack = warp_ops.warp_dense_maps_np(stack, w['a1'], w['a2'],
                                                    w['b1'], w['b2'])
            return stack

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
            rot_ang = geometry.heading_rot_ang(
                trajs.get('ego_traj_present'))
        hf = np.inf if self.height_filter is None else self.height_filter
        w = self._draw_warp()
        params = core.identity_params(window=(0, 1), present_frame=1,
                                      height_thresh=hf)._replace(
            rot_ang=float(rot_ang), trans_dx=float(trans_dx),
            trans_dy=float(trans_dy), zoom=float(zoom_scalar),
            warp_a1=float(w['a1']), warp_a2=float(w['a2']),
            warp_b1=float(w['b1']), warp_b2=float(w['b2']))
        inst_dyn = torch.zeros((1,), dtype=torch.float32, device=self.device)
        outs = self._raster_all(points, valid, fids, inst_dyn,
                                [self._to_device(params.pack())],
                                gen_future)
        return self._harvest(outs, [(rot_ang, trans_dx, trans_dy,
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
