"""Point-sharded BEV rasters over a mesh's 'points' axis.

Counterpart of parallel/sharded.py on torch.distributed. The flat point
buffer is cut into equal shards, one per rank of the points axis; every
rank rasters its shard and the ranks combine over the axis's process
group, so each rank ends with the same (S*7, P, P) float16 stack as the
one-device raster (bev/core.make_raster_fn), or with ``pack='sparse'``
the same (sparse, dense-words fallback) pair of flat uint8 buffers. Two
engines:

  * psum (make_sharded_raster_fn): per-shard accumulators (counts, sums,
    256-bin rgb histograms, z-min), summed (z-min: minimum) over the axis,
    then the channel readout. The readable spec: its histograms are
    (3, P*P, 256) int32 per split, ~200 MB at P = 256.
  * tile (make_tile_sharded_raster_fn): cells stripe over the ranks as
    cell % n; each row is routed once to its cell's owner with a
    fixed-capacity all_to_all, every rank computes its stripe's exact
    statistics with the one-device stats stage
    (ops/sort_raster.split_stats_from_words_flat: the words-form
    segmented-stats kernel on CUDA tensors), and the finished stripes are
    gathered. Its ``group`` rasters a fetch group of augmentation draws
    into one stacked output.

The engines are SPMD: every rank of the points axis calls them with its
own shard, as jax.shard_map's body runs on every device. The accumulators
integrate on one rank, as the JAX package's do on one device:
MeshRasterClient runs there (points-axis rank 0, the controller) and
sends each raster's shard and parameters to the other ranks, which run
serve_mesh_rasters until the controller shuts them down.
"""
from __future__ import annotations

import collections
import math

import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.bev import core as bev_core
from pc_accumulation_lib_tpu_torch.ops import rasterize as ras
from pc_accumulation_lib_tpu_torch.utils import profiling
from pc_accumulation_lib_tpu_torch.ops import sort_raster
from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh


def _params_vec(params, device):
    """(31,) float32 parameter tensor of RasterParams (host values), a
    packed vector or a (pose_vec, aug9) pair."""
    if isinstance(params, bev_core.RasterParams):   # a NamedTuple: first
        return torch.as_tensor(params.pack(), device=device)
    return bev_core.packed_params(params).to(device, torch.float32)


def _features(points):
    return (points[:, cfg.PT_I], points[:, cfg.PT_R:cfg.PT_B + 1],
            points[:, cfg.PT_SEM])


def _check_pack(pack, sparse_cap, pixel_size):
    if pack not in (None, 'sparse'):
        raise ValueError(f"pack must be None or 'sparse', got {pack!r}")
    return (bev_core.default_sparse_cap(pixel_size) if sparse_cap is None
            else sparse_cap)


def make_sharded_raster_fn(mesh, view_size, pixel_size, sem_idxs,
                           int_scaler, int_sep_scaler, int_mid_threshold,
                           rgb_fill=0, points_axis: str = 'points',
                           pack=None, sparse_cap=None):
    """The psum engine. fn(points (M_l,10), valid (M_l,), pt_frame_ids
    (M_l,), inst_dyn (K,), params, gen_future) -> (S*7, P, P) float16 on
    every rank of ``points_axis``, each rank passing its shard; ``params``
    is RasterParams, the packed (31,) tensor or a (pose_vec, aug9)
    pair. ``pack='sparse'``: every rank packs the same combined maps into
    the one-device raster's (sparse, fallback) pair (bev/core
    .sparse_outputs), before the warp."""
    sparse_cap = _check_pack(pack, sparse_cap, pixel_size)
    P = pixel_size
    sem_idxs = dict(sem_idxs)

    def raster(points, valid, pt_frame_ids, inst_dyn, params, gen_future):
        params = bev_core.unpack_params(_params_vec(params, points.device))
        t, cells, static_m, present_m = bev_core.sample_view(
            points, valid, pt_frame_ids, inst_dyn, params, view_size, P)
        inten, rgb, sem = _features(points)
        splits = {'present': static_m & present_m}
        if gen_future:
            splits['future'] = static_m & ~present_m
            splits['full'] = static_m
        chs = {}
        for name, split_mask in splits.items():
            acc = ras.split_accumulators(cells, split_mask, t[:, 2], inten,
                                         rgb, sem, sem_idxs, P)
            acc = {k: (pmesh.pmin(v, mesh, points_axis) if k == 'z_min'
                       else pmesh.psum(v, mesh, points_axis))
                   for k, v in acc.items()}
            for key, v in ras.finalize_split(acc, P, rgb_fill).items():
                chs[f'{key}_{name}'] = v
            chs[f'count_{name}'] = acc['c_road'] + acc['c_not_road']
        return bev_core.emit_outputs(chs, list(splits), params, P,
                                     int_scaler, int_sep_scaler,
                                     int_mid_threshold, pack=pack,
                                     sparse_cap=sparse_cap)

    return raster


class TileRouteOverflow(RuntimeError):
    """A tile-sharded raster dropped rows: some destination stripe got
    more rows than its fixed all_to_all capacity. Raise
    ``dest_cap_factor``: points must not be silently dropped."""


_SPLIT_KEYS = ('road', 'intensity', 'rgb', 'dynamic', 'elevation',
               'count')


class TileShardedRaster:
    """The tile engine (make_tile_sharded_raster_fn builds it). Calls as
    the psum engine does.

    Rows go to the rank owning their cell (cell % n) in blocks of a fixed
    capacity ``int(dest_cap_factor * M_l / n)`` rows per destination. The
    dropped-row count (summed over the axis) and the busiest stripe's row
    count (the axis maximum) are copied to the host without a wait and
    read three calls later: a raster that dropped rows raises
    TileRouteOverflow with the factor it needed. ``drain()`` reads every
    pending count (call it at the end of a job). ``route_peak_rows`` and
    ``route_cap`` hold the busiest stripe seen and the capacity it rode
    against. With ``calibrate_dest_cap``, the first clean reading sets
    the factor once to the observed need times that margin, and at least
    to what a window with every row keyed would need (the blocks' spread),
    quantized to 0.25 and never above the starting factor; later calls
    route with it.
    Every rank reads the same reduced counts, so every rank calibrates,
    and raises, on the same call. ``group`` runs a fetch group of
    rasters and reads its counts as one: dropped rows summed, the peak
    and the capacity at their maximum (the keyed rows at their minimum,
    so the spread floor stays on the safe side).

    Each call's phases are device spans (utils/profiling.py):
    'raster.route', 'raster.all_to_all', 'raster.stripe_stats',
    'raster.gather', 'raster.finalize'."""

    def __init__(self, mesh, view_size, pixel_size, sem_idxs, int_scaler,
                 int_sep_scaler, int_mid_threshold, rgb_fill=0,
                 points_axis: str = 'points', pack=None,
                 dest_cap_factor: float = 4.0,
                 calibrate_dest_cap: float = 2.0, sparse_cap=None):
        self.sparse_cap = _check_pack(pack, sparse_cap, pixel_size)
        self.pack = pack
        self.mesh, self.axis = mesh, points_axis
        self.n = pmesh.axis_size(mesh, points_axis)
        self.P = pixel_size
        if (self.P * self.P) % self.n:
            raise ValueError(f'pixel_size^2 ({self.P * self.P}) must be '
                             f'divisible by the points-axis size ({self.n})'
                             ' for cell striping')
        self.view_size = view_size
        self.sem_idxs = dict(sem_idxs)
        self.scalers = (int_scaler, int_sep_scaler, int_mid_threshold)
        self.rgb_fill = rgb_fill
        self.dest_cap_factor = float(dest_cap_factor)
        self.calibrate_dest_cap = calibrate_dest_cap
        self._calibrated = not calibrate_dest_cap
        self.route_peak_rows = 0
        self.route_cap = None
        self._pending = collections.deque()

    def __call__(self, points, valid, pt_frame_ids, inst_dyn, params,
                 gen_future):
        out, stats = self._raster(points, valid, pt_frame_ids, inst_dyn,
                                  params, gen_future)
        self._push(stats)
        return out

    def group(self, points, valid, pt_frame_ids, inst_dyn, pose_vec, aug9s,
              gen_future):
        """A fetch group: (pose_vec (22,), aug9s (G, 9)) -> the G outputs
        stacked on a leading axis ((G, S*7, P, P) float16, or with the
        sparse pack the pair (G, sparse bytes), (G, fallback bytes) of
        uint8, each raster writing its row)."""
        G = aug9s.shape[0]
        bufs = None
        if self.pack == 'sparse':
            bufs = bev_core.empty_sparse_group(G, self.P, gen_future,
                                               self.sparse_cap, False,
                                               points.device)
        outs, stats = [], []
        for i in range(G):
            out, st = self._raster(
                points, valid, pt_frame_ids, inst_dyn, (pose_vec, aug9s[i]),
                gen_future, out=None if bufs is None
                else (bufs[0][i], bufs[1][i]))
            outs.append(out)
            stats.append(st)
        st = torch.stack(stats)
        self._push(torch.stack([st[:, 0].sum(), st[:, 1].max(),
                                st[:, 2].max(), st[:, 3].min()]))
        return bufs if bufs is not None else torch.stack(outs)

    def _raster(self, points, valid, pt_frame_ids, inst_dyn, params,
                gen_future, out=None):
        """One raster: (its output, the (4,) int64 route counts [dropped,
        busiest stripe, capacity, keyed] reduced over the axis). Device
        spans 'raster.route', 'raster.all_to_all', 'raster.stripe_stats',
        'raster.gather' and 'raster.finalize'."""
        with profiling.span('raster.route', device=True):
            n, P, axis = self.n, self.P, self.axis
            n_cells = P * P
            n_loc = n_cells // n
            params = bev_core.unpack_params(_params_vec(params,
                                                        points.device))
            t, cells, static_m, present_m = bev_core.sample_view(
                points, valid, pt_frame_ids, inst_dyn, params,
                self.view_size, P)
            inten, rgb, sem = _features(points)
            nsplit = 2 if gen_future else 1
            sent = n_cells * nsplit
            base_m = static_m if gen_future else (static_m & present_m)
            isf = ((~present_m).to(torch.int32) if gen_future
                   else torch.zeros_like(cells))
            c2 = torch.where(base_m, cells * nsplit + isf,
                             sent).to(torch.int32)
            road_f = ras.sem_class_mask(
                sem, [self.sem_idxs['road']]).to(torch.float32)
            dyn_f = ras.sem_class_mask(
                sem, [self.sem_idxs[nm] for nm in cfg.DYN_OBJ_CLASSES]).to(
                    torch.float32)
            w1, w2 = sort_raster.pack_payload_words(road_f, dyn_f, rgb,
                                                    inten * road_f, t[:, 2])

            # --- route each keyed row to its cell's owner -------------
            M_l = points.shape[0]
            factor = self.dest_cap_factor
            cap = max(1, int(factor * M_l / n))
            dest = torch.where(c2 < sent, (c2 // nsplit) % n, n)
            sd, order = torch.sort(dest)
            bounds = torch.searchsorted(
                sd, torch.arange(n + 1, dtype=sd.dtype, device=sd.device),
                out_int32=True)
            starts, ends = bounds[:n], bounds[1:]
            idx = (starts[:, None].to(torch.int64)
                   + torch.arange(cap, device=sd.device)[None, :])
            ok = idx < ends[:, None]
            rows = order[idx.clamp(max=M_l - 1)]
            blocks = torch.stack([
                torch.where(ok, c2[rows], sent),
                torch.where(ok, w1[rows], 0),
                torch.where(ok, w2[rows], 0)], dim=1)          # (n, 3, cap)
            per_dest = (ends - starts).to(torch.int64)
        with profiling.span('raster.all_to_all', device=True):
            recv = pmesh.all_to_all(blocks, self.mesh, axis)   # (n, 3, cap)
        with profiling.span('raster.stripe_stats', device=True):
            # --- exact statistics of my stripe -------------------------
            rc2 = recv[:, 0].reshape(-1)
            c2_loc = torch.where(
                rc2 < sent, (rc2 // nsplit) // n * nsplit + rc2 % nsplit,
                n_loc * nsplit).to(torch.int32)
            flat = sort_raster.split_stats_from_words_flat(
                c2_loc, recv[:, 1].reshape(-1), recv[:, 2].reshape(-1),
                n_loc, gen_future, rgb_fill=self.rgb_fill)
        with profiling.span('raster.gather', device=True):
            # --- gather the stripes: global[l*n + d] = stripe d's [l] ---
            meta = (['present', 'future', 'full'] if gen_future
                    else ['present'])
            keys = (_SPLIT_KEYS if self.pack == 'sparse'
                    else _SPLIT_KEYS[:-1])
            mine = torch.cat([flat[f'{k}_{s}'].reshape(-1, n_loc)
                              for s in meta for k in keys])
            g = pmesh.all_gather(mine, self.mesh, axis)    # (n, C, n_loc)
            maps = g.permute(1, 2, 0).reshape(-1, P, P)
        with profiling.span('raster.finalize', device=True):
            chs = {}
            per = 8 if self.pack == 'sparse' else 7     # + the counts
            for si, s in enumerate(meta):
                m = maps[si * per:(si + 1) * per]
                chs.update({f'road_{s}': m[0], f'intensity_{s}': m[1],
                            f'rgb_{s}': m[2:5], f'dynamic_{s}': m[5],
                            f'elevation_{s}': m[6]})
                if self.pack == 'sparse':
                    chs[f'count_{s}'] = m[7]
            out = bev_core.emit_outputs(chs, meta, params, P,
                                        *self.scalers, pack=self.pack,
                                        sparse_cap=self.sparse_cap, out=out)
            # One psum carries the dropped and the keyed rows.
            summed = pmesh.psum(torch.stack(
                [(per_dest - cap).clamp(min=0).sum(), per_dest.sum()]),
                self.mesh, axis)
            stats = torch.stack([summed[0],
                                 pmesh.pmax(per_dest.max(), self.mesh, axis),
                                 torch.full_like(per_dest[0], cap),
                                 summed[1]])
        return out, stats

    def _push(self, stats):
        """Queue one reading of the route counts (copied to the host
        without a wait) and check the readings more than three back."""
        host = stats.to('cpu', non_blocking=True)
        done = None
        if stats.is_cuda:
            done = torch.cuda.Event()
            done.record()
        self._pending.append((host, done, self.dest_cap_factor))
        while len(self._pending) > 3:
            self._check(*self._pending.popleft())

    def _check(self, host, done, factor):
        if done is not None:
            done.synchronize()
        dropped, peak, cap, keyed = (int(v) for v in host.tolist())
        self.route_peak_rows = max(self.route_peak_rows, peak)
        self.route_cap = cap
        if dropped > 0:
            need = factor * peak / max(cap, 1)
            raise TileRouteOverflow(
                f'tile-sharded raster dropped {dropped} rows: the busiest '
                f'destination stripe held {peak} rows vs all-to-all '
                f'capacity {cap} (dest_cap_factor={factor}); '
                f'set dest_cap_factor >= {need:.2f}')
        if not self._calibrated and peak > 0:
            # cap / factor is M_l / n for the call this reading came from.
            # The factor covers this reading's need times the margin, and
            # never less than a full window's: one whose every row is
            # keyed puts about M_l / n rows in each block times the
            # spread of the blocks, the busiest block over the mean block
            # of this reading's keyed rows (keyed / n^2). A first reading
            # on a small early window would otherwise settle on 1.0 and
            # the grown window overflow it.
            self._calibrated = True
            need = peak / max(cap / factor, 1.0)
            spread = peak * self.n * self.n / max(keyed, 1)
            self.dest_cap_factor = min(
                self.dest_cap_factor,
                max(1.0, math.ceil(spread * 4) / 4,
                    math.ceil(need * self.calibrate_dest_cap * 4) / 4))

    def drain(self):
        """Read every pending overflow count (raises TileRouteOverflow)."""
        while self._pending:
            self._check(*self._pending.popleft())


def make_tile_sharded_raster_fn(mesh, view_size, pixel_size, sem_idxs,
                                int_scaler, int_sep_scaler,
                                int_mid_threshold, rgb_fill=0,
                                points_axis: str = 'points', pack=None,
                                dest_cap_factor: float = 4.0,
                                calibrate_dest_cap: float = 2.0,
                                sparse_cap=None):
    """The tile engine (TileShardedRaster). P*P must divide by the
    points-axis size."""
    return TileShardedRaster(mesh, view_size, pixel_size, sem_idxs,
                             int_scaler, int_sep_scaler, int_mid_threshold,
                             rgb_fill, points_axis, pack, dest_cap_factor,
                             calibrate_dest_cap, sparse_cap)


def make_mesh_raster_fn(mesh, view_size, pixel_size, sem_idxs, int_scaler,
                        int_sep_scaler, int_mid_threshold, rgb_fill=0,
                        mesh_impl: str = 'auto', points_axis='points',
                        pack=None, sparse_cap=None):
    """The engine ``mesh_impl`` names: 'tile', 'psum', or 'auto' (tile
    where pixel_size^2 divides by the points-axis size, else psum), with
    the output ``pack`` (None or 'sparse')."""
    if mesh_impl not in ('auto', 'tile', 'psum'):
        raise ValueError(f'mesh_impl must be auto|tile|psum, got '
                         f'{mesh_impl!r}')
    if mesh_impl == 'auto':
        n = pmesh.axis_size(mesh, points_axis)
        mesh_impl = 'tile' if (pixel_size ** 2) % n == 0 else 'psum'
    make = (make_tile_sharded_raster_fn if mesh_impl == 'tile'
            else make_sharded_raster_fn)
    return make(mesh, view_size, pixel_size, sem_idxs, int_scaler,
                int_sep_scaler, int_mid_threshold, rgb_fill,
                points_axis=points_axis, pack=pack, sparse_cap=sparse_cap)


def shard_points_to_mesh(mesh, points, valid, pt_frame_ids,
                         points_axis: str = 'points', src: int = 0):
    """Deal rank ``src``'s flat rows over the points axis: row r goes to
    rank r % n, so every rank holds about live / n of the live rows
    wherever compact_window packed them (jax.device_put onto P('points')
    cuts contiguous blocks instead, which leaves the live rows on the
    first ranks). Every statistic of a raster is free of the row order.
    The other ranks pass None for the three arrays. One collective
    carries all three (frame ids bit-cast to float32)."""
    device = torch.device(mesh.device_type)
    mine = pmesh.axis_rank(mesh, points_axis) == src
    n = pmesh.axis_size(mesh, points_axis)
    rows = None
    m = torch.zeros(1, dtype=torch.int64, device=device)
    if mine:
        if points.shape[0] % n:
            raise ValueError(f'flat point count {points.shape[0]} must be '
                             f'divisible by the points-axis size {n}')
        rows = torch.cat([points.to(torch.float32),
                          valid.to(torch.float32)[:, None],
                          pt_frame_ids.to(torch.int32).view(
                              torch.float32)[:, None]], dim=1).to(device)
        # (M, C) -> (n, M/n, C): block d holds rows d, d + n, d + 2n, ...
        rows = rows.reshape(-1, n, rows.shape[1]).transpose(0, 1)
        rows = rows.reshape(-1, rows.shape[2]).contiguous()
        m.fill_(points.shape[0])
    M = int(pmesh.broadcast(m, mesh, points_axis, src))
    out = torch.empty((M // n, cfg.PT_DIM + 2), dtype=torch.float32,
                      device=device)
    pmesh.scatter(rows, out, mesh, points_axis, src)
    return (out[:, :cfg.PT_DIM].contiguous(), out[:, cfg.PT_DIM] != 0,
            out[:, cfg.PT_DIM + 1].contiguous().view(torch.int32))


def make_multistream_raster_fn(mesh, view_size, pixel_size, sem_idxs,
                               int_scaler, int_sep_scaler, int_mid_threshold,
                               rgb_fill=0, data_axis: str = 'data',
                               points_axis: str = 'points'):
    """Independent streams on a 2-D (data, points) mesh: each data row
    rasters its own streams, point-sharded over that row's points group.

    fn(points (S_l, M_l, 10), valid (S_l, M_l), pt_frame_ids (S_l, M_l),
    inst_dyn (S_l, K), packed (S_l, 31), gen_future) -> (S_l, C, P, P)
    float16: each rank passes its data row's S_l streams and its points
    shard of each, and gets its row's stacks. The streams of a row run
    one after another (the JAX package's lax.map choice: a batched raster
    takes the batched sort and scatter paths)."""
    del data_axis   # the psum combine binds the points axis only
    one = make_sharded_raster_fn(mesh, view_size, pixel_size, sem_idxs,
                                 int_scaler, int_sep_scaler,
                                 int_mid_threshold, rgb_fill, points_axis)

    def raster(points, valid, pt_frame_ids, inst_dyn, packed, gen_future):
        return torch.stack([
            one(points[s], valid[s], pt_frame_ids[s], inst_dyn[s],
                packed[s], gen_future) for s in range(points.shape[0])])

    return raster


# --- one controller, the other ranks of the points axis serving ---------

_OPEN, _POINTS, _RASTER, _CLOSE, _SHUTDOWN, _GROUP = range(6)


def is_controller(mesh, points_axis: str = 'points') -> bool:
    """Rank 0 of the points axis integrates, samples and writes; the
    others serve its rasters."""
    return pmesh.axis_rank(mesh, points_axis) == 0


def _send(mesh, points_axis, op, arg=0):
    pmesh.broadcast(torch.tensor([op, arg], dtype=torch.int64,
                                 device=torch.device(mesh.device_type)),
                    mesh, points_axis)


class MeshRasterClient:
    """The controller's side of the mesh raster. ``config`` holds
    make_mesh_raster_fn's keywords; the workers build the same engine
    from it. Per batch of samples: ``shard`` scatters the flat rows once,
    then each call ``client(params, gen_future)`` rasters them, or
    ``client.group(pose_vec, aug9s, gen_future)`` a fetch group of them
    (tile engine: ``has_group``); ``close`` drains the overflow checks and
    releases the workers' engine."""

    def __init__(self, mesh, config: dict, points_axis: str = 'points'):
        if not is_controller(mesh, points_axis):
            raise ValueError('a mesh raster is driven from rank 0 of the '
                             'points axis; the other ranks run '
                             'serve_mesh_rasters')
        self.mesh, self.axis = mesh, points_axis
        _send(mesh, points_axis, _OPEN)
        pmesh.broadcast_object(dict(config), mesh, points_axis)
        self.raster = make_mesh_raster_fn(mesh, points_axis=points_axis,
                                          **config)
        self._shard = None
        self._inst_dyn = None

    def shard(self, points, valid, pt_frame_ids, inst_dyn):
        n = pmesh.axis_size(self.mesh, self.axis)
        if points.shape[0] % n:
            raise ValueError(
                f'mesh raster: flat point count {points.shape[0]} must be '
                f'divisible by the points-axis size {n}; size AccumConfig '
                '(max_frames * painted_cap, or compact_cap) to a multiple '
                'of it.')
        _send(self.mesh, self.axis, _POINTS, inst_dyn.numel())
        self._shard = shard_points_to_mesh(self.mesh, points, valid,
                                           pt_frame_ids, self.axis)
        self._inst_dyn = pmesh.broadcast(
            inst_dyn.to(torch.float32).contiguous().clone(), self.mesh,
            self.axis)

    def __call__(self, params, gen_future):
        vec = _params_vec(params, self._inst_dyn.device).contiguous()
        _send(self.mesh, self.axis, _RASTER, int(bool(gen_future)))
        pmesh.broadcast(vec.clone(), self.mesh, self.axis)
        return self.raster(*self._shard, self._inst_dyn, vec, gen_future)

    @property
    def has_group(self) -> bool:
        return hasattr(self.raster, 'group')

    def group(self, pose_vec, aug9s, gen_future):
        """The engine's ``group`` on the scattered rows: one request to
        the workers for the whole fetch group."""
        vec = torch.cat([pose_vec.to(torch.float32).reshape(-1),
                         aug9s.to(torch.float32).reshape(-1)]).to(
            self._inst_dyn.device)
        G = aug9s.shape[0]
        _send(self.mesh, self.axis, _GROUP, 2 * G + int(bool(gen_future)))
        pmesh.broadcast(vec.clone(), self.mesh, self.axis)
        return self.raster.group(*self._shard, self._inst_dyn, vec[:22],
                                 vec[22:].view(G, 9), gen_future)

    def close(self):
        try:
            drain = getattr(self.raster, 'drain', None)
            if drain is not None:
                drain()
        finally:
            self._shard = self._inst_dyn = None
            _send(self.mesh, self.axis, _CLOSE)


def serve_mesh_rasters(mesh, points_axis: str = 'points') -> None:
    """The loop of a points-axis rank other than 0: take the controller's
    engine configuration, shards and parameters, raster and join the
    collectives, until shutdown_mesh_workers. An overflow is reported by
    the controller, which reads the same reduced counts on the same
    call."""
    device = torch.device(mesh.device_type)
    raster = shard = inst_dyn = None
    while True:
        hdr = torch.zeros(2, dtype=torch.int64, device=device)
        op, arg = pmesh.broadcast(hdr, mesh, points_axis).tolist()
        if op == _OPEN:
            config = pmesh.broadcast_object(None, mesh, points_axis)
            raster = make_mesh_raster_fn(mesh, points_axis=points_axis,
                                         **config)
        elif op == _POINTS:
            shard = shard_points_to_mesh(mesh, None, None, None, points_axis)
            inst_dyn = pmesh.broadcast(
                torch.empty(arg, dtype=torch.float32, device=device), mesh,
                points_axis)
        elif op == _RASTER:
            vec = pmesh.broadcast(
                torch.empty(31, dtype=torch.float32, device=device), mesh,
                points_axis)
            try:
                raster(*shard, inst_dyn, vec, bool(arg))
            except TileRouteOverflow:
                pass
        elif op == _GROUP:
            G = arg // 2
            vec = pmesh.broadcast(
                torch.empty(22 + 9 * G, dtype=torch.float32, device=device),
                mesh, points_axis)
            try:
                raster.group(*shard, inst_dyn, vec[:22], vec[22:].view(G, 9),
                             bool(arg % 2))
            except TileRouteOverflow:
                pass
        elif op == _CLOSE:
            try:
                getattr(raster, 'drain', lambda: None)()
            except TileRouteOverflow:
                pass
            raster = shard = inst_dyn = None
        elif op == _SHUTDOWN:
            return
        else:
            raise RuntimeError(f'serve_mesh_rasters: unknown op {op}')


def shutdown_mesh_workers(mesh, points_axis: str = 'points') -> None:
    """Controller: end the workers' serve_mesh_rasters loops."""
    _send(mesh, points_axis, _SHUTDOWN)
