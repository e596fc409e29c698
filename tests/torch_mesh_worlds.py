"""Gloo worlds for the port's mesh tests (test helper; imports torch,
numpy and the port, never JAX).

``spawn_world(target, n, tmp, *args)`` starts n processes joined into a
gloo process group by a file under ``tmp`` (no fixed port: the tests run
in parallel), runs ``target(rank, n, tmp, *args)`` on each and joins
them; an exception on any rank raises in the caller. Each target below
runs one test file's port cases and saves what the file compares with
``save``; the test reads it back with ``load``. The seeded inputs come
from the functions below, which the test files call too.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

SEM_IDXS = {'road': 0, 'car': 13, 'truck': 14, 'bus': 15, 'motorcycle': 17}
P, M = 32, 4096


def spawn_world(target: str, n: int, tmp, *args) -> None:
    import torch.multiprocessing as mp
    mp.spawn(_rank_entry, args=(n, str(tmp), target, args), nprocs=n,
             join=True)


def _rank_entry(rank, n, tmp, target, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method='file://' + os.path.join(tmp, f'init_{target}'),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=120))
    try:
        globals()[target](rank, n, tmp, *args)
    except BaseException:
        # The caller sees one rank's error, often a peer's lost
        # connection; every rank's own goes to stderr. The group is
        # destroyed only after success: the spawn ends the peers.
        traceback.print_exc()
        raise
    dist.destroy_process_group()


def save(tmp, name, obj):
    with open(os.path.join(tmp, name + '.pkl'), 'wb') as f:
        pickle.dump(obj, f)


def load(tmp, name):
    with open(os.path.join(tmp, name + '.pkl'), 'rb') as f:
        return pickle.load(f)


# --- seeded inputs ------------------------------------------------------

def make_points(seed, m=M):
    """The flat rows of tests/test_sharding.py: (points (m,10), valid,
    frame ids) in 40 m around the origin, 10% dynamic, 10% invalid."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((m, 10), np.float32)
    pts[:, 0:2] = rng.uniform(-20, 20, size=(m, 2))
    pts[:, 2] = rng.uniform(-2, 3, size=m)
    pts[:, 3] = rng.uniform(0, 1, size=m)
    pts[:, 4:7] = rng.integers(0, 256, size=(m, 3))
    pts[:, 7] = rng.choice([0, 1, 2, 13, 14], size=m)
    pts[:, 9] = rng.choice([0.0, 1.0], size=m, p=[0.9, 0.1])
    valid = rng.uniform(size=m) > 0.1
    fids = rng.integers(0, 10, size=m).astype(np.int32)
    return pts, valid, fids


def raster_params(stream=0):
    """Host raster parameters (numpy-valued RasterParams fields)."""
    from pc_accumulation_lib_tpu_torch.bev import core
    p = core.identity_params(window=(0, 9), present_frame=5 + stream)
    return p._replace(rot_ang=0.3 * stream, trans_dx=0.5 * stream)


def dealt(a, n):
    """``a``'s rows in the order shard_points_to_mesh deals them: rank
    0's (rows 0, n, 2n, ...), then rank 1's, ...; cut into n contiguous
    blocks, this is each rank's shard."""
    a = np.asarray(a)
    return a.reshape((-1, n) + a.shape[1:]).swapaxes(0, 1).reshape(a.shape)


def _shard(pts, valid, fids, r, n):
    m = pts.shape[0] // n
    sl = slice(r * m, (r + 1) * m)
    return (torch.from_numpy(pts[sl]), torch.from_numpy(valid[sl]),
            torch.from_numpy(fids[sl]))


# --- tests/test_torch_mesh.py -------------------------------------------

CALIB_CALLS = 6


def mesh_cases(rank, n, tmp):
    """Every engine on a (1, n) mesh, multi-stream on (2, n/2)."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    mesh = pmesh.make_mesh((1, n), device_type='cpu')
    pts, valid, fids = make_points(0)
    inst = torch.zeros(4)
    params = raster_params()
    shard = sharded.shard_points_to_mesh(
        mesh, *((torch.from_numpy(pts), torch.from_numpy(valid),
                 torch.from_numpy(fids)) if rank == 0
                else (None, None, None)))
    out = {'shard': [t.numpy() for t in shard]}

    psum = sharded.make_sharded_raster_fn(mesh, 40.0, P, SEM_IDXS, 20., 20.,
                                          0.5)
    for gf in (True, False):
        out[f'psum_{gf}'] = psum(*shard, inst, params, gf).float().numpy()

    tile = sharded.make_tile_sharded_raster_fn(mesh, 40.0, P, SEM_IDXS, 20.,
                                               20., 0.5)
    out['tile'] = tile(*shard, inst, params, True).float().numpy()
    packed = torch.from_numpy(params.pack())
    out['tile_tuple'] = tile(*shard, inst, (packed[:22], packed[22:]),
                             True).float().numpy()
    out['tile_packed'] = tile(*shard, inst, packed, False).float().numpy()
    tile.drain()
    out['tile_route'] = (tile.route_peak_rows, tile.route_cap)

    # mesh_impl='auto' at P = 31: 961 cells do not stripe over n ranks.
    auto = sharded.make_mesh_raster_fn(mesh, 40.0, 31, SEM_IDXS, 20., 20.,
                                       0.5)
    out['auto_engine'] = type(auto).__name__
    out['auto_31'] = auto(*shard, inst, params, True).float().numpy()
    try:
        sharded.make_mesh_raster_fn(mesh, 40.0, 31, SEM_IDXS, 20., 20., 0.5,
                                    mesh_impl='tile')
        out['tile_31'] = None
    except ValueError as e:
        out['tile_31'] = str(e)

    over = sharded.make_tile_sharded_raster_fn(
        mesh, 40.0, P, SEM_IDXS, 20., 20., 0.5, dest_cap_factor=0.02,
        calibrate_dest_cap=0)
    over(*shard, inst, params, True)
    try:
        over.drain()
        out['overflow'] = None
    except sharded.TileRouteOverflow as e:
        out['overflow'] = (str(e), over.route_peak_rows, over.route_cap)

    cal = sharded.make_tile_sharded_raster_fn(
        mesh, 40.0, P, SEM_IDXS, 20., 20., 0.5, dest_cap_factor=4.0,
        calibrate_dest_cap=2.0)
    seq, stacks = [], []
    for _ in range(CALIB_CALLS):
        stacks.append(cal(*shard, inst, params, True).float().numpy())
        seq.append((cal.dest_cap_factor, cal.route_cap, cal.route_peak_rows))
    cal.drain()
    seq.append((cal.dest_cap_factor, cal.route_cap, cal.route_peak_rows))
    out['calib'] = seq
    out['calib_stacks'] = (stacks[0], stacks[-1])

    out['growth'] = {c: window_growth(mesh, rank, c) for c in GROWTH}

    if n % 2 == 0 and n >= 4:
        mesh2 = pmesh.make_mesh((2, n // 2), device_type='cpu')
        ms = sharded.make_multistream_raster_fn(mesh2, 40.0, P, SEM_IDXS,
                                                20., 20., 0.5)
        d = pmesh.axis_rank(mesh2, 'data')
        r = pmesh.axis_rank(mesh2, 'points')
        s_pts, s_valid, s_fids = _shard(*make_points(10 + d), r, n // 2)
        out['multistream'] = (d, ms(
            s_pts[None], s_valid[None], s_fids[None], torch.zeros((1, 4)),
            torch.from_numpy(raster_params(d).pack())[None],
            True).float().numpy())
    save(tmp, f'mesh_r{rank}', out)


# --- tests/test_torch_mesh.py: the sparse fetch on 2 ranks --------------

SPARSE_KW = dict(pack='sparse', sparse_cap=(1024, 1024, 768))
GROUP_AUG = np.array(
    [[0.3, 0.5, -0.2, 1.03, 1.0, 0.0, 1.0, 0.0, np.inf],
     [1.9, -0.4, 0.8, 0.97, 1.1, -3e-3, 0.9, 3e-3, 2.0],
     [4.0, 0.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0, np.inf]], np.float32)
SPARSE_STEPS = 3


def _sparse_step_accum(mesh):
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
        Kitti360SemanticPointCloudAccumulator)
    bev = dict(STEP_BEV, fetch_dtype='sparse', fetch_group=2,
               sparse_cap=SPARSE_KW['sparse_cap'])
    if mesh is not None:
        bev['mesh'] = mesh
    kw = accum_kwargs(cfg)
    kw['accum_cfg'] = dataclasses.replace(kw['accum_cfg'],
                                          compact_rungs=(8192, 16384, 32768))
    return Kitti360SemanticPointCloudAccumulator(
        200., _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, bev, device='cpu', **kw)


def _sparse_steps(a, frames):
    a.integrate([frames[0]])
    out = [a.step([f], bev_num=4, gen_future=True, async_fetch=True)()
           for f in frames[1:SPARSE_STEPS + 1]]
    a.sem_bev_generator.close()
    return out


def sparse_mesh_cases(rank, n, tmp):
    """The engines' sparse pack, the tile engine's group, and through the
    controller MeshRasterClient.group and a sparse step() on (1, n); rank
    0 also runs the one-device forms."""
    from pc_accumulation_lib_tpu_torch.bev import core
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    mesh = pmesh.make_mesh((1, n), device_type='cpu')
    full = [torch.from_numpy(a) for a in make_points(0)]
    shard = sharded.shard_points_to_mesh(
        mesh, *(full if rank == 0 else (None,) * 3))
    inst, params = torch.zeros(4), raster_params()
    packed = torch.from_numpy(params.pack())
    pose, aug = packed[:22], torch.from_numpy(GROUP_AUG)
    args = (mesh, 40.0, P, SEM_IDXS, 20., 20., 0.5)
    tile = sharded.make_tile_sharded_raster_fn(*args, **SPARSE_KW)
    psum = sharded.make_sharded_raster_fn(*args, **SPARSE_KW)
    out = {}
    for gf in (True, False):
        for name, eng in (('tile', tile), ('psum', psum)):
            out[f'{name}_{gf}'] = [t.numpy() for t in eng(*shard, inst,
                                                          params, gf)]
    out['group'] = [t.numpy() for t in tile.group(*shard, inst, pose, aug,
                                                  True)]
    tile.drain()
    if rank == 0:
        one = core.make_raster_fn(40.0, P, SEM_IDXS, 20., 20., 0.5,
                                  **SPARSE_KW)
        for gf in (True, False):
            out[f'one_{gf}'] = [t.numpy() for t in one(*full, inst, packed,
                                                       gf)]
        out['one_group'] = [[t.numpy() for t in one(
            *full, inst, (pose, aug[i]), True)] for i in range(len(aug))]
    if sharded.is_controller(mesh):
        try:
            client = sharded.MeshRasterClient(mesh, dict(
                view_size=40.0, pixel_size=P, sem_idxs=SEM_IDXS,
                int_scaler=20., int_sep_scaler=20., int_mid_threshold=0.5,
                mesh_impl='tile', **SPARSE_KW))
            client.shard(*full, inst)
            out['client_group'] = [t.numpy() for t in client.group(
                pose, aug, True)]
            client.close()
            a = _sparse_step_accum(mesh)
            out['step'] = _sparse_steps(a, step_frames())
            out['step_rungs'] = a.rungs_used
        finally:
            sharded.shutdown_mesh_workers(mesh)
        out['step_one'] = _sparse_steps(_sparse_step_accum(None),
                                        step_frames())
    else:
        sharded.serve_mesh_rasters(mesh)
    save(tmp, f'sparse_r{rank}', out)


# step() on a mesh rasters compact_window's buffer, whose live rows sit
# at the front: a first raster on a small early window (it calibrates the
# tile route), then on a grown window ('grown': half the rows live,
# 'full': every row).
GROWTH = {'grown': M // 2, 'full': M}
GROWTH_FIRST = M // 16


def window_rows(live):
    """make_points(1)'s rows, none dynamic (every live row is keyed, as
    in a compacted window), with only the first ``live`` valid."""
    pts, _, fids = make_points(1)
    pts[:, 9] = 0.0
    return pts, np.arange(M) < live, fids


def window_growth(mesh, rank, case):
    """The tile engine on the first window, drained (it calibrates),
    then on the grown one; returns (overflow message or None, the grown
    window's stack, the one-device raster's stack on rank 0, the factor,
    the route counters)."""
    from pc_accumulation_lib_tpu_torch.bev import core
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    inst, params = torch.zeros(4), raster_params()
    tile = sharded.make_tile_sharded_raster_fn(mesh, 40.0, P, SEM_IDXS, 20.,
                                               20., 0.5)
    stack = err = None
    try:
        for live in (GROWTH_FIRST, GROWTH[case]):
            rows = [torch.from_numpy(a) for a in window_rows(live)]
            shard = sharded.shard_points_to_mesh(
                mesh, *(rows if rank == 0 else (None,) * 3))
            stack = tile(*shard, inst, params, True).float().numpy()
            tile.drain()
    except sharded.TileRouteOverflow as e:
        err = str(e)
    one = None
    if rank == 0:
        one = core.make_raster_fn(40.0, P, SEM_IDXS, 20., 20., 0.5)(
            *rows, inst, torch.from_numpy(params.pack()),
            True).float().numpy()
    return (err, stack, one, tile.dest_cap_factor,
            (tile.route_peak_rows, tile.route_cap))


# --- tests/test_torch_mesh_accum.py -------------------------------------

ACCUM_SEQS = ('2013_05_28_drive_0000_sync', '2013_05_28_drive_0002_sync',
              '2013_05_28_drive_0003_sync')
STEP_FRAMES = 6
JOB_FRAMES = 12
STEP_BEV = dict(type='sem', view_size=40, pixel_size=32, int_scaler=20.,
                int_sep_scaler=20., int_mid_threshold=0.5,
                max_trans_radius=2.0, zoom_thresh=0.05, do_warp=True)
CLASSIC_BEV = dict(type='sem', view_size=40, pixel_size=32, int_scaler=20.,
                   int_sep_scaler=20., int_mid_threshold=0.5)
JOB_BEV = {'type': 'sem', 'view_size': 30, 'pixel_size': 64,
           'max_trans_radius': 2.0, 'zoom_thresh': 0.05, 'do_warp': True,
           'int_scaler': 20., 'int_sep_scaler': 20.,
           'int_mid_threshold': 0.5, 'height_filter': None}


def step_frames():
    """(img, pc, GT trainIds) of test_sharding.py's step() drive."""
    from pc_accumulation_lib_tpu_torch.dataloaders.kitti360 import (
        ID2TRAINID, conv_semantic_ids)
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    stream = SyntheticKitti360Stream(n_frames=STEP_FRAMES, step=2.0,
                                     lidar_range=20.0, seed=3,
                                     points_per_frame=2500)
    out = []
    for i in range(STEP_FRAMES):
        img, pc, sem_gt = stream.frame(i)
        out.append((img, pc, conv_semantic_ids(sem_gt.astype(np.int64),
                                               ID2TRAINID)))
    return out


def accum_kwargs(cfg):
    return dict(accum_cfg=cfg.AccumConfig(max_points_per_frame=8192,
                                          max_frames=16, compact_cap=49152),
                icp_cfg=cfg.ICPConfig(max_downsampled=1024, num_iters=12),
                seed=0)


def job_kwargs(cfg, out_dir, manifest_path=None, **kw):
    return dict(
        semseg_model=None, use_gt_sem=True, sequences=list(ACCUM_SEQS),
        start_idxs=[0] * 3, end_idxs=[JOB_FRAMES] * 3,
        accum_horizon_dist=16.0,
        sampling=cfg.SamplingConfig(bev_horizon_dist=6.0,
                                    bev_dist_between_samples=2.0,
                                    bevs_per_sample=2),
        output=cfg.OutputConfig(output_dir=out_dir, subdir_size=4,
                                viz_to_disk=False, async_io=False),
        accum_cfg=cfg.AccumConfig(max_points_per_frame=8192, max_frames=32),
        icp_cfg=cfg.ICPConfig(max_downsampled=1024, num_iters=12), seed=0,
        manifest_path=manifest_path, **kw)


def _calib():
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        make_calib)
    _, H_velo_cam, P_cam_frame = make_calib()
    return dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                p_velo_frame=P_cam_frame @ H_velo_cam)


def _mesh_accum(mesh, bev):
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
        Kitti360SemanticPointCloudAccumulator)
    return Kitti360SemanticPointCloudAccumulator(
        200., _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, dict(bev, mesh=mesh), device='cpu',
        **accum_kwargs(cfg))


class Crash(Exception):
    pass


def accum_cases(rank, n, tmp, root, runner_root):
    """step() and generate_bev() on a (1, n) mesh, run() and the
    scene-sharded job through the runner; rank 0 saves."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.bev.sem_bev import SemBEVGenerator
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as kr
    mesh = pmesh.make_mesh((1, n), device_type='cpu')
    ctl = sharded.is_controller(mesh)
    out = {}

    # step() and generate_bev() through one controller.
    if ctl:
        try:
            frames = step_frames()
            a = _mesh_accum(mesh, STEP_BEV)
            a.integrate([frames[0]])
            steps = []
            for f in frames[1:]:
                bevs = a.step([f], bev_num=2, gen_future=True)
                steps.append((bevs, np.array(a.poses), a.window_start))
            a.sem_bev_generator.close()
            out['step'] = steps
            g = _mesh_accum(mesh, CLASSIC_BEV)
            for f in frames:
                g.integrate([f])
            out['generate_bev'] = g.generate_bev(present_idx=3, bev_num=1,
                                                 gen_future=True)
            g.sem_bev_generator.close()
        finally:
            sharded.shutdown_mesh_workers(mesh)
    else:
        sharded.serve_mesh_rasters(mesh)

    # run() at the runner's default BEV parameters.
    runner_out = os.path.join(tmp, 'runner')
    out['run'] = kr.run(runner_root, output=cfg.OutputConfig(
        runner_out, viz_to_disk=False), device='cpu',
        bev_params=dict(kr.DEFAULT_BEV_PARAMS, mesh=mesh),
        **runner_kwargs(cfg))

    # The scene-sharded job: uninterrupted; crashed after the first
    # sample of the second unit, then resumed; two shards.
    def job(name, **kw):
        return kr.run_sharded(root, bev_params=dict(JOB_BEV, mesh=mesh),
                              device='cpu', **job_kwargs(
                                  cfg, os.path.join(tmp, name),
                                  os.path.join(tmp, name + '.jsonl'), **kw))

    out['job'] = job('job')
    seen = [0]

    def crash(bev, path):
        seen[0] += 1
        if seen[0] == out['job_unit0'] + 1:
            raise Crash(path)

    if ctl:
        from pc_accumulation_lib_tpu_torch.parallel.manifest import (
            CompletionManifest)
        out['job_unit0'] = int(CompletionManifest(os.path.join(
            tmp, 'job.jsonl')).get(ACCUM_SEQS[0])['bevs'])
    try:
        job('crash', on_bev=crash)
        out['crashed'] = False
    except Crash:
        out['crashed'] = True
    out['crash_files'] = seen[0]
    out['resume'] = job('crash')
    out['shards'] = [job('sharded', shard_idx=i, num_shards=2)
                     for i in range(2)]

    # A TileRouteOverflow from close() leaves the unit pending.
    if ctl:
        orig_close = SemBEVGenerator.close

        def close_detects_overflow(self):
            orig_close(self)
            raise sharded.TileRouteOverflow('simulated overflow')

        SemBEVGenerator.close = close_detects_overflow
    try:
        job('overflow')
        out['overflow'] = None
    except sharded.TileRouteOverflow as e:
        out['overflow'] = str(e)
    if ctl:
        SemBEVGenerator.close = orig_close
        save(tmp, 'accum', out)


def runner_kwargs(cfg):
    """The port's test_torch_runner.py sizes."""
    return dict(use_gt_sem=True, sequences=[ACCUM_SEQS[0]], start_idxs=[0],
                end_idxs=[14], accum_horizon_dist=30.0,
                sampling=cfg.SamplingConfig(8.0, 1.0, 2),
                accum_cfg=cfg.AccumConfig(max_points_per_frame=8192,
                                          max_frames=24),
                icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8),
                seed=0)


# --- tests/test_torch_mesh_train.py -------------------------------------

TRAIN_STAGES = (1, 1, 1, 1)
TRAIN_HW = (16, 32)
TRAIN_LR = 1e-3
TRAIN_STEPS = 3


def train_batch(seed):
    """The global batch of step ``seed``: 2 images (one per data rank)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (2, *TRAIN_HW, 3)).astype(np.float32)
    labels = rng.integers(0, 19, (2, *TRAIN_HW)).astype(np.int32)
    labels[0, :3] = 255
    return images, labels


def train_dp_cases(rank, n, tmp, named_path, data_glob):
    """Data-parallel steps on a (n, 1) mesh from the carried weights, and
    train_semseg.run over the world; each rank saves."""
    from pc_accumulation_lib_tpu_torch.models import train as ttrain
    from pc_accumulation_lib_tpu_torch.models.semseg import (
        load_named_tensors)
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.runners import train_semseg as trun
    mesh = pmesh.make_mesh((n, 1), ('data', 'model'), 'cpu')
    state, step = ttrain.make_train_setup(
        lr=TRAIN_LR, stage_sizes=TRAIN_STAGES, compute_dtype=torch.float32,
        device='cpu', mesh=mesh)
    with np.load(named_path) as d:
        load_named_tensors(state.model, dict(d))
    out = {'losses': [], 'after': []}
    for i in range(TRAIN_STEPS):
        images, labels = train_batch(i)
        state, loss = step(state, torch.from_numpy(images),
                           torch.from_numpy(labels))
        out['losses'].append(float(loss))
        if i == 0:
            out['grads'] = {k: p.grad.numpy().copy()
                            for k, p in state.model.named_parameters()}
        if i in (0, TRAIN_STEPS - 1):
            out['after'].append({k: v.numpy().copy() for k, v in
                                 state.model.state_dict().items()})
    try:
        step(state, *(torch.from_numpy(a[:1]) for a in train_batch(9)))
        out['odd_batch'] = None
    except ValueError as e:
        out['odd_batch'] = str(e)
    ckpt_dir = os.path.join(tmp, 'ckpt')
    st, losses = trun.run(data_glob, steps=3, batch_size=2,
                          ckpt_dir=ckpt_dir, ckpt_every=2, dp=n,
                          stage_sizes=TRAIN_STAGES, log_every=3,
                          device='cpu')
    out['run_losses'] = losses
    out['run_step'] = st.step
    out['run_params'] = {k: v.numpy().copy()
                         for k, v in st.model.state_dict().items()}
    save(tmp, f'dp_r{rank}', out)


PP_MICRO, PP_MB, PP_HW, PP_C = 6, 2, (8, 16), 16


def pipeline_batch():
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(PP_MICRO, PP_MB, *PP_HW, PP_C)).astype(np.float32)
    ys = rng.normal(size=(PP_MICRO, PP_MB, *PP_HW, PP_C)).astype(np.float32)
    return xs, ys


def train_pp_cases(rank, n, tmp, stage_path, data_glob):
    """GPipe over an n-stage ('pp',) mesh from the carried stage weights:
    forward, gradients, three pipelined train steps; train_semseg.run
    with dp below the world, which trains DP+TP on (dp, n / dp)."""
    from pc_accumulation_lib_tpu_torch.models import train as ttrain
    from pc_accumulation_lib_tpu_torch.parallel import pipeline as pp
    from pc_accumulation_lib_tpu_torch.runners import train_semseg as trun
    mesh = pp.make_pipeline_mesh(n, 'cpu')
    with np.load(stage_path) as d:
        weights = pp.stage_weights_from_flax(d['kernel'], d['bias'])
    state, step = ttrain.make_pipelined_train_setup(
        mesh, microbatch=PP_MB, hw=PP_HW, channels=PP_C, lr=1e-2,
        stage_weights=weights, device='cpu')
    xs, ys = (torch.from_numpy(a) for a in pipeline_batch())

    def stage_fn(conv, x):
        return x + torch.relu(conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))

    run = pp.gpipe_apply(stage_fn, mesh)
    ys_pp = run(state.model, xs)
    loss = torch.mean((ys_pp - ys) ** 2)
    loss.backward()
    out = {'forward': ys_pp.detach().numpy(),
           'grad': {k: p.grad.numpy().copy()
                    for k, p in state.model.named_parameters()},
           'losses': []}
    for _ in range(3):
        state, loss = step(state, xs, ys)
        out['losses'].append(float(loss))
    st, losses = trun.run(data_glob, steps=3, batch_size=2, dp=n // 2,
                          ckpt_dir=os.path.join(tmp, 'ckpt_tp'),
                          ckpt_every=0, stage_sizes=TRAIN_STAGES,
                          log_every=3, device='cpu')
    out['dp_below_world'] = dict(layout=mesh_layout(st.model),
                                 losses=losses)
    try:
        trun.run(data_glob, steps=1, dp=3, device='cpu')
    except ValueError as e:
        out['dp_below_world']['dp_3'] = str(e)
    save(tmp, f'pp_r{rank}', out)


def mesh_layout(model):
    """(data, model) axis sizes of the mesh a model was cut over."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    mesh = model.model_axis.mesh
    return (pmesh.axis_size(mesh, 'data'), pmesh.axis_size(mesh, 'model'))


# --- tests/test_torch_tp.py ---------------------------------------------

def _numpy(named):
    return {k: v.detach().numpy().copy() for k, v in named.items()}


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters()}


def _stats(model):
    return {k: v for k, v in model.state_dict().items() if 'running' in k}


def _full_state(state):
    """A train state's model tensors and Adam moments, gathered to full
    tensors by name (moments as '<param>.exp_avg', '.exp_avg_sq')."""
    from pc_accumulation_lib_tpu_torch.models import train as ttrain
    model = state.model
    out = ttrain.gather_named(model, model.state_dict())
    params = dict(model.named_parameters())
    for m in ('exp_avg', 'exp_avg_sq'):
        moments = ttrain.gather_named(model, {
            k: state.optimizer.state[p][m] for k, p in params.items()})
        out.update({f'{k}.{m}': v for k, v in moments.items()})
    return out


def _unequal(a, b):
    """Names whose tensors differ in any bit, or are missing from one."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def _replicated_unequal(named, sharded, group=None):
    """Names of replicated tensors that differ between the ranks of
    ``group`` (the world by default), each rank's held to the first's."""
    keys = sorted(k for k in named if k not in sharded)
    flat = torch.cat([named[k].reshape(-1).double() for k in keys])
    rows = [torch.empty_like(flat)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, flat, group=group)
    bad = set()
    for row in rows[1:]:
        at = 0
        for k in keys:
            m = named[k].numel()
            if not torch.equal(row[at:at + m], rows[0][at:at + m]):
                bad.add(k)
            at += m
    return sorted(bad)


def train_tp_cases(rank, n, tmp, named_path, data_glob):
    """DP+TP training on a (n / 2, 2) ('data', 'model') mesh from the
    carried weights, three steps; rank 0 also runs the one-device step
    and saves the full tensors the test holds to JAX. Layout checks,
    checkpoints and weight files across layouts, and train_semseg.run at
    its default layout are judged here, bit for bit, and saved as the
    names that differ; every file written is removed."""
    import shutil

    from pc_accumulation_lib_tpu_torch.models import checkpoint as tckpt
    from pc_accumulation_lib_tpu_torch.models import onnx_port as tport
    from pc_accumulation_lib_tpu_torch.models import train as ttrain
    from pc_accumulation_lib_tpu_torch.models.semseg import (
        load_named_tensors, load_semseg_model)
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.runners import train_semseg as trun
    mesh = pmesh.make_mesh((n // 2, 2), ('data', 'model'), 'cpu')

    def setup(mesh=mesh, seed=0, full=None):
        """make_train_setup from ``seed``, then the ``full`` state dict
        (a one-device model's) loaded in the model's layout."""
        state, step = ttrain.make_train_setup(
            lr=TRAIN_LR, seed=seed, stage_sizes=TRAIN_STAGES,
            compute_dtype=torch.float32, device='cpu', mesh=mesh)
        if full is not None:
            state.model.load_state_dict(ttrain.shard_named(state.model,
                                                           full))
        return state, step

    def batch(i):
        return [torch.from_numpy(a) for a in train_batch(i)]

    out = {}
    state, step = setup()
    sharded = state.model.model_axis.sharded
    out['sharded'] = sorted(sharded)
    # shard_variables keeps rows [r*O/2, (r+1)*O/2) of the seed's tensors.
    seeded = setup(mesh=None)[0].model
    out['unsliced'] = _unequal(state.model.state_dict(),
                               ttrain.shard_named(state.model,
                                                  seeded.state_dict()))
    # The carried weights, loaded into a one-device model by name.
    with np.load(named_path) as d:
        load_named_tensors(seeded, {k: torch.from_numpy(v)
                                    for k, v in d.items()})
    carried = seeded.state_dict()
    del seeded
    state.model.load_state_dict(ttrain.shard_named(state.model, carried))
    # The backward alone: each rank's local gradients of its data rank's
    # mean loss, before the step's collectives.
    probe, _ = setup(full=carried)
    d = pmesh.axis_rank(mesh, 'data')
    images, labels = (t[d:d + 1] for t in batch(0))
    ttrain.cross_entropy_loss(probe.model(images), labels).backward()
    out['grads_unequal'] = _replicated_unequal(
        _grads(probe.model), sharded, mesh.get_group('model'))
    del probe

    out['losses'] = []
    for i in range(TRAIN_STEPS):
        state, loss = step(state, *batch(i))
        out['losses'].append(float(loss))
        if i == 0:
            grads = _numpy(ttrain.gather_named(state.model,
                                               _grads(state.model)))
            stats = _numpy(ttrain.gather_named(state.model,
                                               _stats(state.model)))
        out[f'replicas_unequal_{i}'] = _replicated_unequal(
            state.model.state_dict(), sharded)
    full = ttrain.gather_named(state.model, state.model.state_dict())
    if rank == 0:
        out.update(grads=grads, stats=stats, after=_numpy(full))
        one, one_step = setup(mesh=None, full=carried)
        out['one'] = {'losses': []}
        for i in range(TRAIN_STEPS):
            one, loss = one_step(one, *batch(i))
            out['one']['losses'].append(float(loss))
            if i == 0:
                out['one'].update(grads=_numpy(_grads(one.model)),
                                  stats=_numpy(_stats(one.model)))
        out['one']['after'] = _numpy(one.model.state_dict())
    del grads, stats

    # Checkpoints: the TP state restored on one device and saved there,
    # restored into TP; both go on training as the original does.
    tp_dir, one_dir = (os.path.join(tmp, f'ckpt_{k}') for k in ('tp', 'one'))
    tckpt.save_train_state(tp_dir, state.step, state)
    tp_state = _full_state(state)
    if rank == 0:
        out['ckpt_files'] = sorted(os.listdir(tp_dir))
        one = tckpt.restore_train_state(tp_dir, setup(mesh=None,
                                                      seed=1)[0])
        out['one_restored'] = (one.step, _unequal(_full_state(one),
                                                  tp_state))
        tckpt.save_train_state(one_dir, one.step, one)
        out['one_restored_next'] = float(one_step(one, *batch(3))[1])
        del one
    dist.barrier()
    local = {k: v.clone() for k, v in state.model.state_dict().items()}
    back, back_step = setup(seed=1)
    back = tckpt.restore_train_state(one_dir, back)
    out['back'] = (back.step, _unequal(_full_state(back), tp_state),
                   _unequal(back.model.state_dict(), local))
    back, loss_back = back_step(back, *batch(3))
    state, loss = step(state, *batch(3))
    out['next'] = (float(loss), float(loss_back))
    out['next_unequal'] = _unequal(_full_state(back), _full_state(state))
    del back, tp_state, local

    weights = os.path.join(tmp, 'weights.pt')
    tckpt.save_semseg_weights(state.model, weights)
    exported = tport.export_named_tensors(state.model)
    full = ttrain.gather_named(state.model, state.model.state_dict())
    dist.barrier()
    if rank == 0:
        out['weights_unequal'] = _unequal(load_semseg_model(
            weights, stage_sizes=TRAIN_STAGES, device='cpu').model
            .state_dict(), full)
        out['export_unequal'] = _unequal(
            {k: torch.from_numpy(v) for k, v in exported.items()},
            {k: v for k, v in full.items()
             if not k.endswith('num_batches_tracked')})
    del full, exported

    ckpt_dir = os.path.join(tmp, 'ckpt_run')
    st, losses = trun.run(data_glob, steps=3, batch_size=2,
                          ckpt_dir=ckpt_dir, ckpt_every=2,
                          stage_sizes=TRAIN_STAGES, log_every=3,
                          device='cpu')
    out['run'] = dict(layout=mesh_layout(st.model), losses=losses,
                      step=st.step)
    dist.barrier()
    out['run']['ckpts'] = sorted(os.listdir(ckpt_dir), key=int)
    dist.barrier()
    if rank == 0:
        for path in (tp_dir, one_dir, ckpt_dir):
            shutil.rmtree(path)
        os.remove(weights)
    save(tmp, f'tp{n}_r{rank}', out)
