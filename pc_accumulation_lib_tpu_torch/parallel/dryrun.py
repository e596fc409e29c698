"""One step of every mesh path of the port, on n spawned ranks.

Counterpart of __graft_entry__.dryrun_multichip: at tiny shapes, each
rank of an n-rank process group runs
  1. a DP+TP semseg train step on a (n / tp, tp) ('data', 'model')
     mesh, tp the largest power of two that divides n, at most 4
     (models/train.py);
  2. the psum and tile point-sharded rasters on a (1, n) ('data',
     'points') mesh, the tile raster held to the psum one
     (parallel/sharded.py);
  3. two independent streams on a (2, n/2) mesh, when n is even and at
     least 4;
  4. a GPipe train step on an n-stage ('pp',) mesh
     (parallel/pipeline.py);
  5. the scene-sharded KITTI-360 job through the runner on the (1, n)
     mesh, crashed at its first sample and resumed from its manifest
     (runners/kitti360_bev_gen.run_sharded);
  6. step() of the KITTI-360 accumulator on the (1, n) mesh.

    python -m pc_accumulation_lib_tpu_torch.parallel.dryrun 4 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

SEM_IDXS = {'road': 0, 'car': 13, 'truck': 14, 'bus': 15, 'motorcycle': 17}


def dryrun_multichip(n_ranks: int, device: str = 'cuda') -> dict:
    """Spawn ``n_ranks`` processes (NCCL when each gets a card of its
    own, gloo otherwise) and run the six paths; a rank's failure raises
    here. Returns rank 0's summary, with each rank's backend and card
    under 'placement'."""
    import torch.multiprocessing as mp
    backend = ('nccl' if device == 'cuda'
               and n_ranks <= torch.cuda.device_count() else 'gloo')
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(n_ranks, backend, device, tmp),
                 nprocs=n_ranks, join=True)
        with open(os.path.join(tmp, 'summary.json')) as f:
            summary = json.load(f)
    print(f'dryrun_multichip({n_ranks}): ' + ', '.join(
        f'{k} {v}' for k, v in summary.items()) + f' ok on {device}')
    return summary


def _rank_main(rank, n, backend, device, tmp):
    import torch.distributed as dist

    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    if device == 'cuda':
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        # n ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    pmesh.initialize_multihost('file://' + os.path.join(tmp, 'init'), n,
                               rank, backend=backend)
    summary = _paths(rank, n, device, tmp)
    # Where each rank ran: its group's backend and its card.
    placement = [None] * n
    dist.all_gather_object(placement, dict(
        backend=dist.get_backend(),
        device=torch.cuda.current_device() if device == 'cuda' else None))
    summary['placement'] = placement
    if rank == 0:
        with open(os.path.join(tmp, 'summary.json'), 'w') as f:
            json.dump(summary, f)
    # Only after success: a rank that raises exits at once, and the spawn
    # then ends its peers (destroying an NCCL group while peers wait in a
    # collective can block).
    dist.destroy_process_group()


def _check(ok, what):
    if not ok:
        raise RuntimeError(f'dryrun_multichip: {what}')


def _paths(rank, n, device, tmp):
    from pc_accumulation_lib_tpu_torch.bev import core
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import pipeline
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    dt = torch.device(device).type
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    out = {}

    # 1. DP+TP train step; tp must divide the sharded channel counts
    # (multiples of 256).
    tp = 1
    while tp < 4 and n % (tp * 2) == 0:
        tp *= 2
    mesh = pmesh.make_mesh((n // tp, tp), ('data', 'model'), dt)
    state, step = train_mod.make_train_setup(
        stage_sizes=(1, 1, 1, 1), device=device, mesh=mesh,
        compute_dtype=torch.float32)
    b = 2 * (n // tp)
    images = torch.as_tensor(rng.integers(0, 256, (b, 32, 64, 3)),
                             dtype=torch.float32, device=dev)
    labels = torch.as_tensor(rng.integers(0, 19, (b, 32, 64)), device=dev)
    state, loss = step(state, images, labels)
    _check(bool(torch.isfinite(loss)), 'train step: non-finite loss')
    out['train_loss'] = round(float(loss), 4)
    out['tp'] = tp

    # 2. point-sharded rasters: psum, and tile held to it.
    mesh_pts = pmesh.make_mesh((1, n), ('data', 'points'), dt)
    M, P = 128 * n, 16
    pts = np.zeros((M, 10), np.float32)
    pts[:, 0:2] = rng.uniform(-6, 6, size=(M, 2))
    pts[:, 2] = rng.uniform(-2, 1, size=M)
    pts[:, 4:7] = rng.integers(0, 256, size=(M, 3))
    pts[:, 7] = rng.choice([0, 2, 13], size=M)
    fids = rng.integers(0, 4, size=M).astype(np.int32)
    mine = pmesh.axis_rank(mesh_pts, 'points') == 0
    sp, sv, sf = sharded.shard_points_to_mesh(
        mesh_pts, *((torch.as_tensor(pts, device=dev),
                     torch.ones(M, dtype=torch.bool, device=dev),
                     torch.as_tensor(fids, device=dev)) if mine
                    else (None, None, None)))
    params = core.identity_params(window=(0, 3), present_frame=2)
    inst = torch.zeros(4, device=dev)
    psum_fn = sharded.make_sharded_raster_fn(mesh_pts, 12.0, P, SEM_IDXS,
                                             20., 20., 0.5)
    road = core.unpack_maps(psum_fn(sp, sv, sf, inst, params, True).float(),
                            True)['road_full']
    tile_fn = sharded.make_tile_sharded_raster_fn(mesh_pts, 12.0, P,
                                                  SEM_IDXS, 20., 20., 0.5)
    road_t = core.unpack_maps(tile_fn(sp, sv, sf, inst, params, True).float(),
                              True)['road_full']
    tile_fn.drain()
    _check(road.shape == (P, P) and bool(torch.isfinite(road).all()),
           'psum raster')
    err = float((road_t - road).abs().max())
    _check(err <= 4e-3, f'tile raster {err} from the psum raster')
    out['tile_vs_psum'] = err

    # 3. two streams on a (2, n/2) mesh.
    if n % 2 == 0 and n >= 4:
        mesh_ms = pmesh.make_mesh((2, n // 2), ('data', 'points'), dt)
        ms = sharded.make_multistream_raster_fn(mesh_ms, 12.0, P, SEM_IDXS,
                                                20., 20., 0.5)
        r = pmesh.axis_rank(mesh_ms, 'points')
        m_l = M // (n // 2)
        sl = slice(r * m_l, (r + 1) * m_l)
        d = pmesh.axis_rank(mesh_ms, 'data')
        pk = params._replace(rot_ang=0.5 * d).pack()
        stacks = ms(torch.as_tensor(pts[None, sl], device=dev),
                    torch.ones((1, m_l), dtype=torch.bool, device=dev),
                    torch.as_tensor(fids[None, sl], device=dev),
                    torch.zeros((1, 4), device=dev),
                    torch.as_tensor(pk[None], device=dev), True)
        _check(stacks.shape[0] == 1 and bool(torch.isfinite(
            stacks.float()).all()), 'multistream raster')
        out['streams'] = 2

    # 4. GPipe train step.
    pp_mesh = pipeline.make_pipeline_mesh(n, dt)
    pp_state, pp_step = train_mod.make_pipelined_train_setup(
        pp_mesh, microbatch=1, hw=(8, 16), channels=8, device=device)
    xs = torch.as_tensor(rng.normal(size=(4, 1, 8, 16, 8)),
                         dtype=torch.float32, device=dev)
    ys = torch.as_tensor(rng.normal(size=(4, 1, 8, 16, 8)),
                         dtype=torch.float32, device=dev)
    pp_state, pp_loss = pp_step(pp_state, xs, ys)
    _check(bool(torch.isfinite(pp_loss)), 'pipeline step: non-finite loss')
    out['pp_loss'] = round(float(pp_loss), 4)

    # 5. the scene-sharded job, crashed at its first sample and resumed.
    out['job_bevs'] = _job(mesh_pts, mine, device, tmp)
    # 6. step() on the mesh.
    out['mesh_step_bevs'] = _mesh_step(mesh_pts, mine, device)
    return out


class _Crash(Exception):
    pass


def _job(mesh, mine, device, tmp):
    import glob

    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        write_kitti360_layout)
    from pc_accumulation_lib_tpu_torch.parallel.manifest import (
        CompletionManifest)
    from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen

    seqs = ['2013_05_28_drive_0000_sync', '2013_05_28_drive_0002_sync']
    root = os.path.join(tmp, 'data')
    out = os.path.join(tmp, 'bevs')
    manifest_path = os.path.join(tmp, 'manifest.jsonl')
    if mine:
        for i, seq in enumerate(seqs):
            write_kitti360_layout(root, seq=seq, n_frames=10, step=2.0,
                                  lidar_range=15.0, seed=5 + i)
    kw = dict(
        semseg_model=None, use_gt_sem=True, sequences=seqs,
        start_idxs=[0, 0], end_idxs=[10, 10], accum_horizon_dist=12.0,
        bev_params={'type': 'sem', 'view_size': 20, 'pixel_size': 32,
                    'int_scaler': 20., 'int_sep_scaler': 20.,
                    'int_mid_threshold': 0.5, 'mesh': mesh},
        sampling=cfg.SamplingConfig(bev_horizon_dist=3.0,
                                    bev_dist_between_samples=1.0,
                                    bevs_per_sample=1),
        output=cfg.OutputConfig(output_dir=out, viz_to_disk=False,
                                async_io=False),
        accum_cfg=cfg.AccumConfig(max_points_per_frame=8192, max_frames=16),
        icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8), seed=0,
        manifest_path=manifest_path, device=device)

    def crash_first(bev, path):
        raise _Crash(path)

    try:
        kitti360_bev_gen.run_sharded(root, on_bev=crash_first, **kw)
    except _Crash:
        pass
    else:
        _check(not mine, 'job: the crash hook never fired')
    stats = kitti360_bev_gen.run_sharded(root, **kw)
    if not mine:
        return 0
    man = CompletionManifest(manifest_path)
    _check(all(man.is_done(s) for s in seqs), 'job resume: units open')
    total = sum(int(man.get(s)['bevs']) for s in seqs)
    files = glob.glob(os.path.join(out, '**', 'bev_*.pkl.gz'),
                      recursive=True)
    _check(total >= 2 and len(files) == total, (total, len(files)))
    _check(stats['bevs'] == total, (stats, total))
    return total


def _mesh_step(mesh, mine, device):
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
        Kitti360SemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream, make_calib)
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    if not mine:
        sharded.serve_mesh_rasters(mesh)
        return 0
    try:
        _, H_velo_cam, P_cam_frame = make_calib()
        calib = dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                     p_velo_frame=P_cam_frame @ H_velo_cam)
        accum = Kitti360SemanticPointCloudAccumulator(
            12.0, calib, 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
            cfg.DEFAULT_SEM_IDXS, True,
            dict(type='sem', view_size=20, pixel_size=16,
                 max_trans_radius=1.0, zoom_thresh=0.05, do_warp=True,
                 int_scaler=20., int_sep_scaler=20., int_mid_threshold=0.5,
                 mesh=mesh),
            accum_cfg=cfg.AccumConfig(max_points_per_frame=2048,
                                      max_frames=8),
            icp_cfg=cfg.ICPConfig(max_downsampled=256, num_iters=6),
            seed=0, device=device)
        stream = SyntheticKitti360Stream(n_frames=3, step=2.0,
                                         lidar_range=10.0, seed=7,
                                         points_per_frame=800)
        try:
            accum.integrate([stream.frame(0)])
            bevs = []
            for i in range(1, 3):
                bevs += accum.step([stream.frame(i)], bev_num=2,
                                   gen_future=True)
                _check(np.isfinite(bevs[-1]['road_full'].astype(
                    np.float32)).all(), 'mesh step(): non-finite maps')
        finally:
            accum.sem_bev_generator.close()
        return len(bevs)
    finally:
        sharded.shutdown_mesh_workers(mesh)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('n_ranks', type=int)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == '__main__':
    main()
